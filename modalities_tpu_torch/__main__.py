"""CLI of the port:

    python -m modalities_tpu_torch run --config_file_path <yaml>
        [--experiments_root_path <dir>] [--device cuda|cpu]
    python -m modalities_tpu_torch warmstart --config_file_path <yaml>
        --last_checkpoint_info_file_path <json> [--experiments_root_path <dir>] [--device cuda|cpu]
    python -m modalities_tpu_torch serve --config_file_path <yaml>
        [--requests_file_path <jsonl> [--output_file_path <jsonl>] | --http_port <port>]
        [--fleet] [--device cuda|cpu]

`serve` replays a JSONL file, serves HTTP (`--http_port`, or the config's
`http_port`; 0 = an ephemeral port) until SIGTERM/SIGINT drains it, or with
neither reads prompts from stdin. A `fleet` or `disagg` config
(configs/config_fleet.yaml, configs/config_disagg.yaml; `--fleet` refuses
any other) serves its workers behind a router on `--http_port`.

All run on the CUDA card unless `--device cpu`. MODALITIES_TPU_LOG_LEVEL sets
the level of the package's logger (default INFO), as in the JAX CLI. `run` and `warmstart` set
PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True unless the caller set it.
`warmstart` resumes from the folder a `last_checkpoint_info.json` names
(`warmstart`, below).

`run` and `warmstart` train on N cards under the launcher, one process a card
(card LOCAL_RANK; the config's device_mesh degrees multiply to N):

    python -m torch.distributed.run --nproc_per_node N -m modalities_tpu_torch run --config_file_path <yaml>

Without a launcher they build a world-1 process group themselves."""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path
from typing import Optional


def warmstart(config_file_path: Path, last_checkpoint_info_file_path: Path,
              experiments_root_path: Optional[Path] = None, device: Optional[str] = None):
    """Resume training from the last checkpoint (the JAX CLI's `warmstart`):
    the folder `last_checkpoint_info.json` names is resolved and verified
    before the config is built, since the folder's name is the metadata store
    (seen steps and tokens, and the sampler's skip, are parsed from it); if it
    fails its manifest, the ring is walked back to the newest folder that
    verifies. The config reads the folder through `${warmstart_env:...}`.
    Returns the `Main` that ran (its `train_step` holds the final state) and
    the run's published interval results."""
    from modalities_tpu_torch.main import Main
    from modalities_tpu_torch.resilience.manifest import resolve_resume_folder

    resume_folder = str(resolve_resume_folder(last_checkpoint_info_file_path))

    def warmstart_env(key: str):
        if key in ("checkpoint_paths", "checkpoint_folder_path"):
            return resume_folder
        raise ValueError(f"Unknown warmstart_env variable {key!r}")

    main_obj = Main(config_file_path, experiments_root_path=experiments_root_path, device=device,
                    additional_resolver_funs={"warmstart_env": warmstart_env})
    return main_obj, main_obj.run()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m modalities_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    run_p = sub.add_parser("run", help="train from a YAML config")
    run_p.add_argument("--config_file_path", type=Path, required=True)
    run_p.add_argument("--experiments_root_path", type=Path, default=None)
    run_p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    warm_p = sub.add_parser("warmstart", help="resume training from the last checkpoint")
    warm_p.add_argument("--config_file_path", type=Path, required=True)
    warm_p.add_argument("--last_checkpoint_info_file_path", type=Path, required=True)
    warm_p.add_argument("--experiments_root_path", type=Path, default=None)
    warm_p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    serve_p = sub.add_parser("serve", help="continuous-batching text serving from the ring or the paged KV cache")
    serve_p.add_argument("--config_file_path", type=Path, required=True)
    serve_p.add_argument("--requests_file_path", type=Path, default=None, help="JSONL of requests to replay")
    serve_p.add_argument("--output_file_path", type=Path, default=None)
    serve_p.add_argument("--http_port", type=int, default=None,
                         help="serve the streaming HTTP front end on this port (0 = ephemeral)")
    serve_p.add_argument("--fleet", action="store_true",
                         help="fleet mode: N workers (or a prefill and a decode tier) behind a router; the config's "
                              "serving_component.variant_key must be 'fleet' or 'disagg'; --http_port sets the "
                              "ROUTER port")
    serve_p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    # the JAX package's logger level switch (a name logging does not know raises)
    logging.getLogger("modalities_tpu_torch").setLevel(os.environ.get("MODALITIES_TPU_LOG_LEVEL", "INFO").upper())

    if args.command in ("run", "warmstart"):
        # before the first allocation on the card: a training step's activations come and go in many sizes,
        # and expandable segments let the caching allocator reuse freed memory across them
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        if args.command == "warmstart":
            warmstart(args.config_file_path, args.last_checkpoint_info_file_path, args.experiments_root_path,
                      device=args.device)
            return 0
        from modalities_tpu_torch.main import Main

        Main(args.config_file_path, experiments_root_path=args.experiments_root_path, device=args.device).run()
        return 0

    from modalities_tpu_torch.serving.serve import serve

    serve(args.config_file_path, args.requests_file_path, args.output_file_path, device=args.device,
          http_port=args.http_port, fleet=args.fleet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
