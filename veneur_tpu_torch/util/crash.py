"""Crash reporting: the ConsumePanic pattern (port of
veneur_tpu/util/crash.py; the server CLI registers Sentry as a reporter
when `sentry_dsn` is set and sentry-sdk is installed).

Behavioral parity with reference sentry.go:22-60: every long-lived
goroutine (thread here) wraps its body in ConsumePanic, which reports
the exception (to a pluggable reporter — Sentry in the reference, a
structured log + optional hook here), flushes, then re-raises so the
process dies loudly and the supervisor restarts it (crash = recovery).
A logging hook forwards every ERROR+ record to the reporter (reference
cmd/veneur/main.go:71-79 logrus hook).
"""

from __future__ import annotations

import functools
import logging
import threading
import traceback
from typing import Callable, List

logger = logging.getLogger("veneur_tpu_torch.crash")

# pluggable reporter: receives (exc, formatted traceback)
_reporters: List[Callable[[BaseException, str], None]] = []


def register_reporter(cb: Callable[[BaseException, str], None]) -> None:
    _reporters.append(cb)


def clear_reporters() -> None:
    _reporters.clear()


def consume_panic(exc: BaseException) -> None:
    """Report a fatal exception to every reporter, then re-raise."""
    tb = "".join(traceback.format_exception(
        type(exc), exc, exc.__traceback__))
    logger.critical("panic: %s\n%s", exc, tb)
    for reporter in list(_reporters):
        try:
            reporter(exc, tb)
        except Exception:
            logger.exception("crash reporter failed")
    raise exc


def guarded(fn: Callable) -> Callable:
    """Wrap a thread body so fatal exceptions hit consume_panic."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            consume_panic(e)
    return wrapper


class ReportingHandler(logging.Handler):
    """Forwards ERROR+ log records to the crash reporters (non-fatal;
    the reference's logrus Sentry hook)."""

    def __init__(self, level=logging.ERROR):
        super().__init__(level)

    def emit(self, record: logging.LogRecord) -> None:
        for reporter in list(_reporters):
            try:
                exc = record.exc_info[1] if record.exc_info else None
                reporter(exc or RuntimeError(record.getMessage()),
                         self.format(record))
            except Exception:
                pass


def spawn_guarded(target: Callable, name: str = "",
                  daemon: bool = True, args=()) -> threading.Thread:
    t = threading.Thread(target=guarded(target), name=name,
                         daemon=daemon, args=args)
    t.start()
    return t
