"""The port's server CLI: load a YAML config, start the server on the
card (or on the CPU with `-device cpu`), and run until SIGINT/SIGTERM
(or POST /quitquitquit with `http_quit`). SIGHUP reloads the `alerts:`
block from the config file. SIGUSR2 hands the listeners to a replacement
process spawned from the same command line, then shuts this one down
(core/restart.py). ERROR records and thread panics go to the crash
reporters (util/crash.py), Sentry among them when `sentry_dsn` is set
and sentry-sdk is installed. `VENEUR_<KEY>` and `VENEUR_TPU_<FIELD>`
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


def install_crash_reporting(cfg, log) -> None:
    """ERROR+ records and thread panics route to the registered crash
    reporters (reference sentry.go + the logrus hook,
    cmd/veneur/main.go:63-79); with `sentry_dsn`, Sentry is one of them
    when sentry-sdk is installed, else a warning says crashes log
    locally only."""
    from veneur_tpu_torch.util import crash
    logging.getLogger().addHandler(crash.ReportingHandler())
    if cfg.sentry_dsn:
        try:
            import sentry_sdk
            sentry_sdk.init(dsn=cfg.sentry_dsn.reveal())
            crash.register_reporter(
                lambda exc, tb: sentry_sdk.capture_exception(exc))
        except ImportError:
            log.warning("sentry_dsn set but sentry-sdk is unavailable; "
                        "crashes log locally only")


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

    install_crash_reporting(cfg, log)

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
    # SIGUSR2: zero-gap graceful restart through the SO_REUSEPORT handoff
    # (the einhorn equivalent, reference server.go:1404)
    from veneur_tpu_torch.core import restart
    restart.install(server.shutdown, cfg.http_address)
    while not stop.wait(0.5):
        if server.shutdown_complete.is_set():
            # /quitquitquit or a SIGUSR2 handoff shut the server down
            return 0
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
