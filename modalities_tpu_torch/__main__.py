"""CLI of the port:

    python -m modalities_tpu_torch run --config_file_path <yaml>
        [--experiments_root_path <dir>] [--device cuda|cpu]
    python -m modalities_tpu_torch warmstart --config_file_path <yaml>
        --last_checkpoint_info_file_path <json> [--experiments_root_path <dir>] [--device cuda|cpu]
    python -m modalities_tpu_torch serve --config_file_path <yaml>
        [--requests_file_path <jsonl> [--output_file_path <jsonl>] | --http_port <port>]
        [--fleet] [--device cuda|cpu]
    python -m modalities_tpu_torch data analyze_serve --sink_path <file|dir> [--as_json]
    python -m modalities_tpu_torch data analyze_fleet --sink_path <file|dir> [--sink_path ...] [--as_json]
    python -m modalities_tpu_torch data check_slo --slo_path <yaml> [--sink_path ...] [--bench_path ...]
        [--trajectory_path <dir>] [--memscope_path ...] [--as_json]

`serve` replays a JSONL file, serves HTTP (`--http_port`, or the config's
`http_port`; 0 = an ephemeral port) until SIGTERM/SIGINT drains it, or with
neither reads prompts from stdin. A `fleet` or `disagg` config
(configs/config_fleet.yaml, configs/config_disagg.yaml; `--fleet` refuses
any other) serves its workers behind a router on `--http_port`.

`data` reads what a serve run records with MODALITIES_TPU_SERVE_TELEMETRY_DIR
set (the JAX CLI's commands, options and exit codes): `analyze_serve` the
latency tables of the `serve_request` records, `analyze_fleet` one span tree
per request stitched from the routers' and the workers' sinks, `check_slo`
a verdict per objective of an SLO spec over recorded runs (exit 1 when one
breaches). The JAX CLI's other `data` commands raise NotImplementedError
naming ROADMAP.md Queue 1 item 6.

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
import json
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


# the JAX CLI's `data` commands the port does not have yet
_UNPORTED_DATA = ("create_raw_index", "pack_encoded_data", "merge_packed_data", "shuffle_tokenized_data",
                  "shuffle_jsonl_data", "create_shuffled_dataset_chunk", "create_shuffled_jsonl_chunk",
                  "prepare_instruction_tuning_data", "analyze_debug_logs", "analyze_telemetry", "analyze_perfscope",
                  "analyze_memscope", "analyze_bench", "tune_kernels")


def _add_data_commands(sub) -> None:
    data_p = sub.add_parser("data", help="analyze what serve runs recorded; check them against SLOs")
    data_sub = data_p.add_subparsers(dest="data_command", required=True)
    serve_p = data_sub.add_parser("analyze_serve", help="latency tables of a serve run's request records")
    serve_p.add_argument("--sink_path", type=Path, required=True,
                         help="a telemetry_rank_N.jsonl file, or the telemetry folder holding them")
    serve_p.add_argument("--as_json", action="store_true", help="emit the summary dict as JSON")
    fleet_p = data_sub.add_parser("analyze_fleet", help="one span tree per request across routers and workers")
    fleet_p.add_argument("--sink_path", dest="sink_paths", type=Path, action="append", required=True,
                         help="router and/or worker sinks (files or folders); repeatable")
    fleet_p.add_argument("--as_json", action="store_true", help="emit the stitched traces as JSON")
    slo_p = data_sub.add_parser("check_slo", help="judge recorded runs against an SLO spec (exit 1 on a breach)")
    slo_p.add_argument("--slo_path", type=Path, required=True, help="YAML SLO spec (the `slo:` block's grammar)")
    slo_p.add_argument("--sink_path", dest="sink_paths", type=Path, action="append", default=[],
                       help="telemetry JSONL sink (file or folder); repeatable")
    slo_p.add_argument("--bench_path", dest="bench_paths", type=Path, action="append", default=[],
                       help="benchmark JSON-lines output; the last line's numbers become bench_<key> gauges")
    slo_p.add_argument("--trajectory_path", type=Path, default=None,
                       help="folder of BENCH_r*/MULTICHIP_r* round artifacts")
    slo_p.add_argument("--memscope_path", dest="memscope_paths", type=Path, action="append", default=[],
                       help="memscope.json static report; repeatable")
    slo_p.add_argument("--as_json", action="store_true", help="emit the verdict dict as JSON")
    for name in _UNPORTED_DATA:
        data_sub.add_parser(name, help="not in the port yet (ROADMAP.md, Queue 1 item 6)").add_argument(
            "rest", nargs=argparse.REMAINDER)


def data_command(args, parser) -> int:
    """`data analyze_serve | analyze_fleet | check_slo` (the JAX CLI's)."""
    if args.data_command in _UNPORTED_DATA:
        raise NotImplementedError(f"data {args.data_command}: not in the port yet (ROADMAP.md, Queue 1 item 6)")
    paths = [args.sink_path] if args.data_command == "analyze_serve" else list(args.sink_paths)
    if args.data_command == "check_slo":
        paths += [args.slo_path, *args.bench_paths, *args.memscope_paths]
        paths += [args.trajectory_path] if args.trajectory_path is not None else []
    missing = [str(p) for p in paths if not p.exists()]
    if missing:
        parser.error(f"path(s) do not exist: {', '.join(missing)}")
    if args.data_command == "analyze_serve":
        from modalities_tpu_torch.serving.analyze import format_serve_table, load_serve_records, summarize_serve

        summary = summarize_serve(load_serve_records(args.sink_path))
        print(json.dumps(summary) if args.as_json else format_serve_table(summary))
        return 0
    if args.data_command == "analyze_fleet":
        from modalities_tpu_torch.serving.analyze import (
            format_fleet_trace_tree,
            load_fleet_records,
            stitch_fleet_traces,
        )

        traces = stitch_fleet_traces(load_fleet_records(args.sink_paths))
        print(json.dumps(traces) if args.as_json else format_fleet_trace_tree(traces))
        return 0
    from modalities_tpu_torch.telemetry.metrics import MetricsRegistry
    from modalities_tpu_torch.telemetry.slo import (
        evaluate_recorded,
        load_slo_spec,
        replay_bench_lines_into_registry,
        replay_memscope_into_registry,
        replay_sink_into_registry,
        replay_trajectory_into_registry,
    )

    registry = MetricsRegistry()
    replayed = sum(replay_sink_into_registry(p, registry) for p in args.sink_paths)
    replayed += sum(replay_bench_lines_into_registry(p, registry) for p in args.bench_paths)
    if args.trajectory_path is not None:
        replayed += replay_trajectory_into_registry(args.trajectory_path, registry)
    replayed += sum(replay_memscope_into_registry(p, registry) for p in args.memscope_paths)
    objectives, _ = load_slo_spec(args.slo_path)
    report = evaluate_recorded(objectives, registry)
    report["records_replayed"] = replayed
    if args.as_json:
        print(json.dumps(report))
    else:
        width = max(len(o.name) for o in objectives)
        for objective in objectives:
            value = report["values"].get(objective.name)
            if objective.name in report["breaching"]:
                verdict = "BREACH"
            elif objective.name in report["skipped"]:
                verdict = "skipped (no data)"
            else:
                verdict = "ok"
            shown = f"{value:.6g}" if value is not None else "-"
            print(f"{objective.name:<{width}}  {shown:>12}  {verdict}  ({objective.expr})")
        print(f"{len(objectives)} objectives over {replayed} replayed records: "
              + ("BREACHING: " + ", ".join(report["breaching"]) if report["breaching"] else "all ok"))
    return 1 if report["breaching"] else 0


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
    _add_data_commands(sub)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    # the JAX package's logger level switch (a name logging does not know raises)
    logging.getLogger("modalities_tpu_torch").setLevel(os.environ.get("MODALITIES_TPU_LOG_LEVEL", "INFO").upper())

    if args.command == "data":
        return data_command(args, parser)
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
