"""ingest_batch_ms: the mean milliseconds of one Server.handle_packet_batch
call (256 datagrams of 32 lines), by the harness's span around it."""


def read(run):
    xs = run.get("ingest_batch_s")
    return sum(xs) / len(xs) * 1e3 if xs else None
