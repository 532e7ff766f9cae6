"""The port's server CLI: load a YAML config, start the server on the
card (or on the CPU with `-device cpu`), and run until SIGINT/SIGTERM
(or POST /quitquitquit with `http_quit`). SIGHUP reloads the `alerts:`
block from the config file. `VENEUR_<KEY>` and `VENEUR_TPU_<FIELD>`
environment variables override the file (config.read_config).

Run: python -m veneur_tpu_torch.cmd.veneur -f config.yaml [-device cpu]
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

import veneur_tpu_torch
from veneur_tpu_torch.config import read_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-tpu-torch")
    ap.add_argument("-f", dest="config", help="YAML config file")
    ap.add_argument("-device", dest="device", default=None,
                    help="torch device of the tables (default: cuda:0; "
                         "'cpu' runs every kernel's plain version)")
    ap.add_argument("-validate-config", action="store_true",
                    dest="validate_config",
                    help="parse the config and exit")
    ap.add_argument("-version", action="store_true", dest="version")
    ap.add_argument("-debug", action="store_true")
    args = ap.parse_args(argv)

    if args.version:
        print(veneur_tpu_torch.__version__)
        return 0
    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    log = logging.getLogger("veneur")
    try:
        cfg = read_config(args.config)
    except (OSError, ValueError, TypeError) as e:
        log.error("could not read config: %s", e)
        return 1
    if args.debug:
        cfg.debug = True
    if args.validate_config:
        print("config OK")
        return 0

    from veneur_tpu_torch.core.server import Server
    server = Server(cfg, device=args.device)
    server.start()
    log.info("veneur-tpu-torch %s started on %s (statsd=%s)",
             veneur_tpu_torch.__version__, server.device,
             cfg.statsd_listen_addresses)

    stop = threading.Event()

    def handle_signal(signum, frame):
        log.info("received signal %d, shutting down", signum)
        stop.set()

    def handle_hup(signum, frame):
        # hot-reload the alert rules; a bad table keeps the old one
        try:
            server.reload_alerts(args.config)
        except Exception:
            log.exception("alerts reload failed; keeping the old rules")

    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGHUP, handle_hup)
    while not stop.wait(0.5):
        if server.shutdown_complete.is_set():
            return 0  # /quitquitquit shut the server down
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
