"""CLI of the port:

    python -m modalities_tpu_torch run --config_file_path <yaml>
        [--experiments_root_path <dir>] [--test_comm] [--device cuda|cpu]
        [--resilient --last_checkpoint_info_file_path <json> [--max_restarts N]
         [--backoff_base_s S] [--warmstart_config_file_path <yaml>]]
    python -m modalities_tpu_torch warmstart --config_file_path <yaml>
        --last_checkpoint_info_file_path <json> [--experiments_root_path <dir>] [--device cuda|cpu]
    python -m modalities_tpu_torch generate_text --config_file_path <yaml> [--device cuda|cpu]
    python -m modalities_tpu_torch serve --config_file_path <yaml>
        [--requests_file_path <jsonl> [--output_file_path <jsonl>] | --http_port <port>]
        [--fleet] [--device cuda|cpu]
    python -m modalities_tpu_torch data analyze_telemetry --sink_path <file|dir> [--as_json]
    python -m modalities_tpu_torch data analyze_serve --sink_path <file|dir> [--as_json]
    python -m modalities_tpu_torch data analyze_fleet --sink_path <file|dir> [--sink_path ...] [--as_json]
    python -m modalities_tpu_torch data check_slo --slo_path <yaml> [--sink_path ...] [--bench_path ...]
        [--trajectory_path <dir>] [--memscope_path ...] [--as_json]

`run --test_comm` first all-gathers rank-stamped tensors over the world
group and checks every slot. `run --resilient` supervises the run as a child
process (resilience/supervisor.py): a resumable exit (75: preemption, anomaly
rollback) restarts it as a `warmstart` from the newest verified checkpoint,
with exponential backoff and a crash-loop budget. The multi-host resume vote
and elastic repair (`--host_count` > 1, `--host_id`, `--resume_quorum`,
`--resume_vote_deadline_s`, `--coordination_dir_path`, `--min_hosts`) raise
NotImplementedError naming ROADMAP.md Queue 1 item 7. MODALITIES_TPU_FAULTS
arms fault points (resilience/faults.py) for `run` and `warmstart`.

`run`, `warmstart`, `serve` and `generate_text` write a per-rank error record
`error_rank_<rank>.json` (rank, hostname, timestamp, error, resumable,
stacktrace) into $MODALITIES_TPU_ERROR_LOG_DIR (default: the working
directory) when they fail; a resumable failure exits 75.

`generate_text` reads prompts from stdin, one a line, until EOF, and prints
each completion (inference/inference.py).

`serve` replays a JSONL file, serves HTTP (`--http_port`, or the config's
`http_port`; 0 = an ephemeral port) until SIGTERM/SIGINT drains it, or with
neither reads prompts from stdin. A `fleet` or `disagg` config
(configs/config_fleet.yaml, configs/config_disagg.yaml; `--fleet` refuses
any other) serves its workers behind a router on `--http_port`.

`data` reads what runs record (the JAX CLI's commands, options and exit
codes): `analyze_telemetry` a training run's sink (`<experiment>/telemetry`,
written by default): the goodput table a rank, the stragglers across ranks
and the last MFU waterfall; on what a serve run records with
MODALITIES_TPU_SERVE_TELEMETRY_DIR set, `analyze_serve` the latency tables of the `serve_request` records, `analyze_fleet` one span tree
per request stitched from the routers' and the workers' sinks, `check_slo`
a verdict per objective of an SLO spec over recorded runs (exit 1 when one
breaches). The JAX CLI's other `data` commands raise NotImplementedError
naming ROADMAP.md Queue 1 item 6. `analyze_telemetry` writes the error record
when it fails, as `run` does.

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
import functools
import json
import logging
import os
import socket
import sys
import traceback
from datetime import datetime
from pathlib import Path
from typing import Optional

from modalities_tpu_torch.resilience.errors import RESUMABLE_EXIT_CODE, ResumableError

logger = logging.getLogger("modalities_tpu_torch")


def _exception_handling(func):
    """A per-rank JSON error record (the JAX CLI's, modalities_tpu/__main__.py:27-60);
    a `ResumableError` (preemption, anomaly rollback) exits RESUMABLE_EXIT_CODE,
    so a supervisor can tell "warmstart me" from a crash."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except Exception as e:
            rank = int(os.environ.get("RANK", 0))
            error_record = {
                "rank": rank,
                "hostname": socket.gethostname(),
                "timestamp": datetime.now().isoformat(),
                "error": repr(e),
                "resumable": isinstance(e, ResumableError),
                "stacktrace": traceback.format_exc(),
            }
            error_dir = Path(os.environ.get("MODALITIES_TPU_ERROR_LOG_DIR", "."))
            error_dir.mkdir(parents=True, exist_ok=True)
            error_file = error_dir / f"error_rank_{rank}.json"
            with open(error_file, "w") as f:
                json.dump(error_record, f, indent=2)
            if isinstance(e, ResumableError):
                logger.warning("Run stopped resumably (%s); exiting %d for the supervisor. Error log: %s", e,
                               RESUMABLE_EXIT_CODE, error_file)
                raise SystemExit(RESUMABLE_EXIT_CODE) from e
            logger.error("Run failed; error log written to %s", error_file)
            raise

    return wrapper


_CLUSTER_FLAGS = ("host_count", "host_id", "resume_quorum", "resume_vote_deadline_s", "coordination_dir_path",
                  "min_hosts")
_CLUSTER_DEFAULTS = {"host_count": 1, "host_id": 0, "resume_vote_deadline_s": 120.0}


@_exception_handling
def run(args) -> int:
    """`run`: train, or with `--resilient` supervise the training."""
    refused = [f"--{name}" for name in _CLUSTER_FLAGS if getattr(args, name) != _CLUSTER_DEFAULTS.get(name)]
    if refused:
        raise NotImplementedError(f"{', '.join(refused)}: the multi-host resume vote and elastic repair are cluster "
                                  "resilience (ROADMAP.md, Queue 1 item 7)")
    if args.resilient:
        if args.last_checkpoint_info_file_path is None:
            raise SystemExit("--resilient requires --last_checkpoint_info_file_path")
        from modalities_tpu_torch.resilience.supervisor import run_resilient

        extra = ("--device", args.device) + (("--test_comm",) if args.test_comm else ())
        return run_resilient(
            config_file_path=args.config_file_path,
            last_checkpoint_info_file_path=args.last_checkpoint_info_file_path,
            experiments_root_path=args.experiments_root_path,
            warmstart_config_file_path=args.warmstart_config_file_path,
            max_restarts=args.max_restarts,
            backoff_base_s=args.backoff_base_s,
            extra_args=extra,
        )
    from modalities_tpu_torch.main import Main

    main_obj = Main(args.config_file_path, experiments_root_path=args.experiments_root_path, device=args.device)
    if args.test_comm:
        main_obj.test_communication()
    main_obj.run()
    return 0


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
                  "prepare_instruction_tuning_data", "analyze_debug_logs", "analyze_perfscope",
                  "analyze_memscope", "analyze_bench", "tune_kernels")


def _add_data_commands(sub) -> None:
    data_p = sub.add_parser("data", help="analyze what training and serve runs recorded; check them against SLOs")
    data_sub = data_p.add_subparsers(dest="data_command", required=True)
    telemetry_p = data_sub.add_parser("analyze_telemetry",
                                      help="goodput buckets a rank, stragglers and the MFU waterfall of a run's sink")
    telemetry_p.add_argument("--sink_path", type=Path, required=True,
                             help="a telemetry_rank_N.jsonl file, or the telemetry folder holding them")
    telemetry_p.add_argument("--as_json", action="store_true", help="emit the summary dict as JSON")
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


@_exception_handling
def analyze_telemetry(sink_path: Path, as_json: bool) -> None:
    """`data analyze_telemetry`: every wall second of each rank in its goodput
    bucket, the slowest rank a bucket (two ranks or more) and the run's last
    MFU waterfall (the JAX CLI's tables and JSON)."""
    from modalities_tpu_torch.telemetry.goodput import (
        format_goodput_table,
        format_straggler_table,
        straggler_summary,
        summarize_sink,
    )
    from modalities_tpu_torch.telemetry.waterfall import format_waterfall_table, last_waterfall_from_sink

    summary = summarize_sink(sink_path)
    stragglers = straggler_summary(summary)
    waterfall = last_waterfall_from_sink(sink_path)
    if as_json:
        print(json.dumps({**summary, "stragglers": stragglers, "mfu_waterfall": waterfall}))
        return
    print(format_goodput_table(summary))
    if len(summary.get("ranks", {})) > 1:
        print("\nstragglers (slowest rank per bucket):")
        print(format_straggler_table(stragglers))
    if waterfall is not None:
        print("\nMFU waterfall (peak -> achieved, deductions close the gap exactly):")
        print(format_waterfall_table(waterfall))


def data_command(args, parser) -> int:
    """`data analyze_telemetry | analyze_serve | analyze_fleet | check_slo` (the JAX CLI's)."""
    if args.data_command in _UNPORTED_DATA:
        raise NotImplementedError(f"data {args.data_command}: not in the port yet (ROADMAP.md, Queue 1 item 6)")
    paths = [args.sink_path] if args.data_command in ("analyze_serve", "analyze_telemetry") else list(args.sink_paths)
    if args.data_command == "check_slo":
        paths += [args.slo_path, *args.bench_paths, *args.memscope_paths]
        paths += [args.trajectory_path] if args.trajectory_path is not None else []
    missing = [str(p) for p in paths if not p.exists()]
    if missing:
        parser.error(f"path(s) do not exist: {', '.join(missing)}")
    if args.data_command == "analyze_telemetry":
        analyze_telemetry(args.sink_path, args.as_json)
        return 0
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
    run_p.add_argument("--test_comm", action="store_true", help="run a pre-flight collective check first")
    run_p.add_argument("--resilient", action="store_true",
                       help="supervise the run: warmstart on resumable exits (preemption, rollback)")
    run_p.add_argument("--last_checkpoint_info_file_path", type=Path, default=None,
                       help="where the resume pointer lives or will appear (required with --resilient)")
    run_p.add_argument("--max_restarts", type=int, default=3, help="crash-loop cap for --resilient")
    run_p.add_argument("--backoff_base_s", type=float, default=1.0,
                       help="exponential-backoff base between --resilient restarts")
    run_p.add_argument("--warmstart_config_file_path", type=Path, default=None,
                       help="the config --resilient resumes children with")
    for name, kind in (("host_count", int), ("host_id", int), ("resume_quorum", int),
                       ("resume_vote_deadline_s", float), ("coordination_dir_path", Path), ("min_hosts", int)):
        run_p.add_argument(f"--{name}", type=kind, default=_CLUSTER_DEFAULTS.get(name),
                           help="cluster resilience: not in the port yet (ROADMAP.md, Queue 1 item 7)")
    warm_p = sub.add_parser("warmstart", help="resume training from the last checkpoint")
    warm_p.add_argument("--config_file_path", type=Path, required=True)
    warm_p.add_argument("--last_checkpoint_info_file_path", type=Path, required=True)
    warm_p.add_argument("--experiments_root_path", type=Path, default=None)
    warm_p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    gen_p = sub.add_parser("generate_text", help="interactive text generation from a checkpoint (prompts on stdin)")
    gen_p.add_argument("--config_file_path", type=Path, required=True)
    gen_p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
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
            _exception_handling(warmstart)(args.config_file_path, args.last_checkpoint_info_file_path,
                                           args.experiments_root_path, device=args.device)
            return 0
        return run(args)
    if args.command == "generate_text":
        _generate_text(args.config_file_path, device=args.device)
        return 0
    _serve(args.config_file_path, args.requests_file_path, args.output_file_path, device=args.device,
           http_port=args.http_port, fleet=args.fleet)
    return 0


@_exception_handling
def _generate_text(config_file_path: Path, device: str) -> None:
    from modalities_tpu_torch.inference.inference import generate_text

    generate_text(config_file_path, device=device)


@_exception_handling
def _serve(*args, **kwargs) -> None:
    from modalities_tpu_torch.serving.serve import serve

    serve(*args, **kwargs)


if __name__ == "__main__":
    sys.exit(main())
