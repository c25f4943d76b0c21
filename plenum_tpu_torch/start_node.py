"""Start a node of the port from on-disk keys + genesis (runs until
SIGTERM or Ctrl-C).

    python -m plenum_tpu_torch.start_node --name Alpha --base-dir /tmp/pool \
        [--device cuda|cpu]

The pool directory is what `plenum_tpu_torch.bootstrap.generate_pool`
writes (the JAX package's `generate_pool` writes the same files). The
node's kernels (ed25519 verify, SHA-256 ledger leaves, SHA3 state levels)
run on the card unless `--device cpu` is given; without a card and without
`--device cpu` the node refuses to start.

Reference: setup.py:152 start_plenum_node.
"""
import argparse
import asyncio
import json
import logging
import os
import signal


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", required=True)
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the node's kernels run (default: the card)")
    ap.add_argument("--verbose", "-v", action="count", default=0,
                    help="-v = DEBUG, -vv = TRACE (wire-level)")
    ap.add_argument("--stats-file", default=None,
                    help="when the node stops, write its device, kernel "
                         "launch counts and native host branches here as "
                         "JSON")
    ap.add_argument("--log-file", default=None,
                    help="per-node rotating log file; default "
                         "<base>/<name>/logs/<name>.log, '-' disables")
    args = ap.parse_args(argv)
    base_dir = os.path.expanduser(args.base_dir)

    from plenum_tpu_torch.bootstrap import build_networked_node, run_node
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.ops import resolve_device
    from plenum_tpu_torch.utils.log import TRACE, Logger
    device = resolve_device(args.device)
    config = Config.load(base_dir)
    level = (TRACE if args.verbose >= 2
             else logging.DEBUG if args.verbose == 1
             else config.LOG_LEVEL)
    log = Logger()
    log.apply_config(config)
    log.setLevel(level)
    log.enableStdLogging()
    log_file = args.log_file
    if log_file is None:
        log_file = os.path.join(base_dir, args.name, "logs",
                                args.name + ".log")
    if log_file != "-":
        log.enableFileLogging(log_file, max_bytes=config.LOG_MAX_BYTES,
                              backup_count=config.LOG_BACKUP_COUNT)
    node = build_networked_node(args.name, base_dir, config=config,
                                device=device)
    logging.getLogger(__name__).info("%s: kernels on %s", args.name, device)

    async def serve():
        # SIGTERM ends the prod loop cleanly, so run_node closes the
        # stacks and the file stores see no torn write
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        loop.add_signal_handler(signal.SIGTERM, stop.set)
        await run_node(node, stop)

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass
    if args.stats_file:
        from plenum_tpu_torch.bootstrap import native_backends
        from plenum_tpu_torch.ops import launch_counts
        tmp = args.stats_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"name": args.name, "device": str(device),
                       "pid": os.getpid(), "kernels": launch_counts(),
                       "view_no": node.node.replica.view_no,
                       "native": native_backends()}, f)
        os.replace(tmp, args.stats_file)


if __name__ == "__main__":
    main()
