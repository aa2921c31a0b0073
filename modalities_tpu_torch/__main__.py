"""CLI of the port:

    python -m modalities_tpu_torch run --config_file_path <yaml>
        [--experiments_root_path <dir>] [--device cuda|cpu]
    python -m modalities_tpu_torch serve --config_file_path <yaml>
        --requests_file_path <jsonl> [--output_file_path <jsonl>] [--device cuda|cpu]

Both run on the CUDA card unless `--device cpu`. `run` sets
PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True unless the caller set it."""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m modalities_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    run_p = sub.add_parser("run", help="train from a YAML config")
    run_p.add_argument("--config_file_path", type=Path, required=True)
    run_p.add_argument("--experiments_root_path", type=Path, default=None)
    run_p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    serve_p = sub.add_parser("serve", help="continuous-batching text serving from the ring KV cache")
    serve_p.add_argument("--config_file_path", type=Path, required=True)
    serve_p.add_argument("--requests_file_path", type=Path, required=True, help="JSONL of requests to replay")
    serve_p.add_argument("--output_file_path", type=Path, default=None)
    serve_p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")

    if args.command == "run":
        # before the first allocation on the card: a training step's activations come and go in many sizes,
        # and expandable segments let the caching allocator reuse freed memory across them
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        from modalities_tpu_torch.main import Main

        Main(args.config_file_path, experiments_root_path=args.experiments_root_path, device=args.device).run()
        return 0

    from modalities_tpu_torch.serving.serve import serve

    serve(args.config_file_path, args.requests_file_path, args.output_file_path, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
