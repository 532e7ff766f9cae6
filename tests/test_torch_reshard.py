"""The port's elastic reshard (parallel/reshard.py and its hooks) against
the JAX package's (tests/test_reshard.py), on the CPU: the port runs with
`device="cpu"`, the JAX package on conftest's 8 virtual CPU devices, and
both take the same seeded packets.

Mirrors TestMigrationCells, TestElasticCutover and
TestReadyAndQuerySemantics with their parametrisations. The contract: a
live N -> M reshard flushes what a store never resharded flushes, held
to tests/test_reshard.py's rule against the port's own control
(counters, gauges, llhist and HLL exact; t-digest percentile rows within
rtol 1e-6), and to the JAX package's control and resharded server within
the kernel tolerance of tests/test_torch_sharded_server.py (t-digest
rows rtol 2e-5 / atol 1e-4, the llhist `.sum` dot product to 1e-12,
everything else exact); the strict ledger balances every interval; a
crash after the WAL append replays exactly once into a 2-shard server,
segments of either package. Also here: a 1-shard target, device_loss,
and a readout in flight across a cutover."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from veneur_tpu.core.query import QueryError as JQueryError
from veneur_tpu.core.query import ReshardRetry as JReshardRetry
from veneur_tpu.parallel import reshard as jreshard
from veneur_tpu.parallel.sharded_server import ShardedServingPlane as JPlane
from veneur_tpu.parallel.sharded_server import local_shard_devices
from veneur_tpu_torch.config import config_from_dict
from veneur_tpu_torch.core.httpapi import HTTPApi
from veneur_tpu_torch.core.query import (QueryError, QuerySpec,
                                         ReshardRetry, parse_tags)
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.parallel import collectives
from veneur_tpu_torch.parallel.reshard import (ReshardError,
                                               migration_cells)
from veneur_tpu_torch.parallel.sharded_server import ShardedServingPlane
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

from test_reshard import (_assert_bit_identical, _assert_ledger_clean,
                          _feed, _flushed, _shutdown, corpus, wait_until)
from test_reshard import mk_server as jmk_server

_FULL = 1 << 64
K1_TOL = dict(rtol=2e-5, atol=1e-4)


def mk_server(shard_groups=None, **kw):
    """The port's server with tests/test_reshard.py's mk_server config
    (its shards over `shard_groups` when given)."""
    raw = {"interval": "3600s", "hostname": "test",
           "statsd_listen_addresses": [], "ledger_strict": True,
           "tpu": {"counter_capacity": 128, "gauge_capacity": 128,
                   "histo_capacity": 128, "set_capacity": 64,
                   "llhist_capacity": 64, "batch_cap": 512}}
    for k, v in kw.items():
        if k.startswith("tpu."):
            raw["tpu"][k[len("tpu."):]] = v
        else:
            raw[k] = v
    sink = ChannelMetricSink()
    return Server(config_from_dict(raw), device="cpu",
                  extra_metric_sinks=[sink], shard_groups=shard_groups), sink


def _assert_like_jax(got: dict, want: dict):
    """The port's flush against the JAX package's: t-digest rows within
    K1's tolerance, the llhist `.sum` (a dot product over the rows read
    out) to 1e-12, every other row exact."""
    assert set(got) == set(want), (sorted(set(want) - set(got)),
                                   sorted(set(got) - set(want)))
    for key, w in want.items():
        name = key[0]
        if name.startswith("rs.t.") or "percentile" in name:
            np.testing.assert_allclose(got[key], w, err_msg=str(key),
                                       **K1_TOL)
        elif name.startswith("rs.ll.") and name.endswith(".sum"):
            assert got[key] == pytest.approx(w, rel=1e-12), key
        else:
            assert got[key] == w, key


def _close(*servers):
    for server in servers:
        _shutdown(server)


# ---------------------------------------------------------------------------
# plan geometry
# ---------------------------------------------------------------------------


class TestMigrationCells:
    @pytest.mark.parametrize("n_old,n_new", [
        (2, 3), (3, 2), (2, 4), (4, 2), (3, 5), (8, 3), (1, 2), (5, 5)])
    def test_cells_partition_the_digest_space(self, n_old, n_new):
        """The JAX package's cells, which are contiguous, cover
        [0, 2^64), number at most N+M-1, and route every digest inside
        a cell to the cell's single old and new home."""
        cells = migration_cells(n_old, n_new)
        assert cells == jreshard.migration_cells(n_old, n_new)
        assert len(cells) <= n_old + n_new - 1
        assert cells[0]["lo"] == 0
        assert cells[-1]["hi"] == _FULL
        for prev, cur in zip(cells, cells[1:]):
            assert prev["hi"] == cur["lo"]
        rng = np.random.RandomState(7)
        for cell in cells:
            width = cell["hi"] - cell["lo"]
            probes = {cell["lo"], cell["hi"] - 1} | {
                cell["lo"] + int(rng.randint(0, min(width, 1 << 62)))
                for _ in range(8)}
            for d in probes:
                assert (d * n_old) >> 64 == cell["old_home"], (cell, d)
                assert (d * n_new) >> 64 == cell["new_home"], (cell, d)

    def test_identity_reshard_has_no_moving_cells(self):
        assert migration_cells(4, 4) == jreshard.migration_cells(4, 4)
        for cell in migration_cells(4, 4):
            assert cell["old_home"] == cell["new_home"]


# ---------------------------------------------------------------------------
# the cutover
# ---------------------------------------------------------------------------


class TestElasticCutover:
    def test_live_split_bit_identity_vs_control(self, tmp_path):
        """2 -> 3 while packets keep coming: rows fed before, during and
        after the reshard all land; the flush equals the port's never
        resharded control by tests/test_reshard.py's rule and the JAX
        package's control within the kernel tolerance; the strict ledger
        balances on both."""
        server, obs = mk_server(**{"tpu.shards": 2},
                                reshard_spool_dir=str(tmp_path / "wal"))
        control, cobs = mk_server(**{"tpu.shards": 2})
        jcontrol, jobs = jmk_server(**{"tpu.shards": 2})
        try:
            for s in (server, control, jcontrol):
                _feed(s, corpus(0))
            ctl = server.reshard
            ctl.begin(shards=3)
            mid = corpus(1)
            fed = 0
            deadline = time.time() + 300.0
            while ctl.state != "idle" or ctl.epoch == 0:
                assert not ctl.last_error, ctl.last_error
                assert time.time() < deadline, "reshard never finished"
                if fed < len(mid):
                    server.handle_metric_packet(mid[fed])
                    fed += 1
                else:
                    time.sleep(0.01)
            _feed(server, mid[fed:])
            for s in (control, jcontrol):
                _feed(s, mid)

            assert ctl.epoch == 1 and ctl.cutovers == 1
            assert ctl.last_error == ""
            assert ctl.segments_written > 0, "cutover wrote no WAL"
            assert ctl.inflight_metrics() == 0
            assert server.store.shard_plane.n == 3
            assert len(server.store.histos.states) == 3
            assert server.store.counters.state["sum"].shape[0] == 3

            for s in (server, control, jcontrol):
                _feed(s, corpus(2))
            spec = QuerySpec.build(metric="rs.c.0", kind="count",
                                   tags=parse_tags("env:t"))
            assert (server.query_plane.query(spec)["value"]
                    == control.query_plane.query(spec)["value"])

            for s in (server, control, jcontrol):
                s.flush()
            got = _flushed(obs.drain())
            _assert_bit_identical(got, _flushed(cobs.drain()))
            _assert_like_jax(got, _flushed(jobs.drain()))
            _assert_ledger_clean(server)
            _assert_ledger_clean(control)
        finally:
            _close(server, control, jcontrol)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_crash_mid_cutover_replays_exactly_once(self, tmp_path, writer):
        """The merge killed after every range segment is durable: a
        fresh port server at the OLD shard count replays the segments
        exactly once and flushes like the control. The JAX package's
        segments replay into the port the same way."""
        spool_dir = str(tmp_path / "wal")
        make = mk_server if writer == "port" else jmk_server
        server, _obs = make(**{"tpu.shards": 2}, reshard_spool_dir=spool_dir)
        control, cobs = mk_server(**{"tpu.shards": 2})
        jcontrol, jobs = jmk_server(**{"tpu.shards": 2})
        try:
            for s in (server, control, jcontrol):
                _feed(s, corpus(0))
            ctl = server.reshard

            def die(batch):
                raise RuntimeError("simulated SIGKILL mid-merge")
            ctl._merge_decoded = die

            error = ReshardError if writer == "port" else \
                jreshard.ReshardError
            with pytest.raises(error, match="SIGKILL"):
                ctl.begin(shards=3, block=True)
            written = ctl.segments_written
            assert written > 0
            assert list((tmp_path / "wal").iterdir())
        finally:
            _shutdown(server)

        server2, obs2 = mk_server(**{"tpu.shards": 2},
                                  reshard_spool_dir=spool_dir)
        try:
            replayed = server2.reshard.recover()
            assert replayed == written
            assert server2.reshard.replayed_segments == written
            assert server2.reshard.recover() == 0
            for s in (server2, control, jcontrol):
                s.flush()
            got = _flushed(obs2.drain())
            _assert_bit_identical(got, _flushed(cobs.drain()))
            _assert_like_jax(got, _flushed(jobs.drain()))
            _assert_ledger_clean(server2)
        finally:
            _close(server2, control, jcontrol)

    def test_append_fault_degrades_without_loss(self, tmp_path):
        """Every WAL append faulted (the chaos seam): each cell merges
        from memory, with no loss, and the faults are counted, as in the
        JAX package."""
        kw = dict(reshard_spool_dir=str(tmp_path / "wal"),
                  chaos_enabled=True, chaos_reshard_append_fault_nth=1)
        server, obs = mk_server(**{"tpu.shards": 2}, **kw)
        kw["reshard_spool_dir"] = str(tmp_path / "jwal")
        jserver, jobs_r = jmk_server(**{"tpu.shards": 2}, **kw)
        control, cobs = mk_server(**{"tpu.shards": 2})
        try:
            for s in (server, jserver, control):
                _feed(s, corpus(0))
            for s in (server, jserver):
                s.reshard.begin(shards=3, block=True)
            assert server.reshard.append_faults == \
                jserver.reshard.append_faults > 0
            assert server.reshard.segments_written == 0
            assert server.reshard.epoch == 1
            assert server.chaos.reshard_faulted_appends == \
                server.reshard.append_faults
            rows = {(r[0], tuple(r[3])) for r in
                    server.chaos.telemetry_rows()}
            assert ("chaos.injected_errors", ("seam:reshard_append",)) in rows
            for s in (server, jserver, control):
                _feed(s, corpus(1))
                s.flush()
            got = _flushed(obs.drain())
            _assert_bit_identical(got, _flushed(cobs.drain()))
            _assert_like_jax(got, _flushed(jobs_r.drain()))
            _assert_ledger_clean(server)
        finally:
            _close(server, jserver, control)

    @pytest.mark.parametrize("how", ["to_one_shard", "device_loss"])
    def test_scale_down_like_jax(self, tmp_path, how):
        """A 1-shard target (the JAX controller takes any device list, so
        its plane holds one shard) and a forced scale-down after a lost
        shard (on one card every shard shares the device, so the lost
        shard's state is still read): both flush like the JAX package's
        server after the same reshard, and like a never resharded
        control."""
        n0 = 2 if how == "to_one_shard" else 3
        server, obs = mk_server(**{"tpu.shards": n0},
                                reshard_spool_dir=str(tmp_path / "wal"))
        jserver, jobs = jmk_server(**{"tpu.shards": n0},
                                   reshard_spool_dir=str(tmp_path / "jwal"))
        control, cobs = mk_server(**{"tpu.shards": n0})
        try:
            for s in (server, jserver, control):
                _feed(s, corpus(0))
            for s in (server, jserver):
                if how == "to_one_shard":
                    s.reshard.begin(shards=1, block=True)
                else:
                    s.reshard.device_loss(1, block=True)
            want_n = 1 if how == "to_one_shard" else 2
            assert server.store.shard_plane.n == \
                jserver.store.shard_plane.n == want_n
            assert server.reshard.device_losses == \
                jserver.reshard.device_losses
            assert server.reshard.segments_written == \
                jserver.reshard.segments_written
            for s in (server, jserver, control):
                _feed(s, corpus(1))
                s.flush()
            got = _flushed(obs.drain())
            _assert_bit_identical(got, _flushed(cobs.drain()))
            _assert_like_jax(got, _flushed(jobs.drain()))
            _assert_ledger_clean(server)
        finally:
            _close(server, jserver, control)

    @pytest.mark.parametrize("how", ["devices", "device_loss", "shards"])
    def test_four_groups_reshard_like_a_control(self, tmp_path, how):
        """A 4-shard store over four placement groups (all the CPU, so
        the per-group applies, partial merges and copies run here)
        reshards onto an explicit device list, loses shard 3's device, or
        takes five shards over its own four groups: each flushes like a
        one-group control that was never resharded, and the strict
        ledger balances."""
        groups = [torch.device("cpu")] * 4
        server, obs = mk_server(shard_groups=groups, **{"tpu.shards": 4},
                                reshard_spool_dir=str(tmp_path / "wal"))
        control, cobs = mk_server(**{"tpu.shards": 4})
        try:
            assert server.store.shard_plane.n_groups == 4
            for s in (server, control):
                _feed(s, corpus(0))
            ctl = server.reshard
            if how == "devices":
                ctl.begin(devices=groups[:3], block=True)
            elif how == "device_loss":
                ctl.device_loss(3, block=True)
            else:
                ctl.begin(shards=5, block=True)
            plane = server.store.shard_plane
            want_n, want_groups = (5, 4) if how == "shards" else (3, 3)
            assert (plane.n, plane.n_groups) == (want_n, want_groups)
            assert plane.describe()["devices"] == ["cpu:0"] * want_n
            assert len(collectives.groups_of(
                server.store.counters.state)) == want_groups
            assert ctl.device_losses == (how == "device_loss")
            for s in (server, control):
                _feed(s, corpus(1))
                s.flush()
            _assert_bit_identical(_flushed(obs.drain()),
                                  _flushed(cobs.drain()))
            _assert_ledger_clean(server)
        finally:
            _close(server, control)

    def test_readout_across_a_cutover_recycles_nothing(self):
        """A generation swapped out before a cutover and read out after
        it never becomes a spare of the new plane, in either package; and
        a server with flush_async delivers the interval in flight across
        a reshard like the control."""
        # the table level: swap_out, cutover, readout, recycle
        server, _obs = mk_server(**{"tpu.shards": 2})
        jserver, _jobs = jmk_server(**{"tpu.shards": 2})
        try:
            for s in (server, jserver):
                _feed(s, corpus(0))
            snap = server.store.counters.swap_out()
            jsnap = jserver.store.counters.swap_out()
            server.store.counters.reshard_swap(
                ShardedServingPlane(3, torch.device("cpu")))
            jserver.store.counters.reshard_swap(
                JPlane(local_shard_devices(3)))
            server.store.counters.readout(snap)
            server.store.counters.snapshot_finish(snap)
            server.store.counters.recycle(snap)
            jsnap = jserver.store.counters.readout(jsnap)
            jserver.store.counters.snapshot_finish(jsnap)
            jserver.store.counters.recycle(jsnap)
            assert server.store.counters._spare is None
            assert jserver.store.counters._spare is None
            assert server.store.counters.state["sum"].shape[0] == 3
        finally:
            _close(server, jserver)

        # the server level, flush_async: the cutover joins the readout
        server, obs = mk_server(**{"tpu.shards": 2}, flush_async=True)
        control, cobs = mk_server(**{"tpu.shards": 2})
        try:
            for s in (server, control):
                _feed(s, corpus(0))
            server.flush()  # interval 1 swapped, its readout in flight
            control.flush()
            want1 = _flushed(cobs.drain())
            assert server._inflight_flushes
            server.reshard.begin(shards=3, block=True)
            for table in (server.store.counters, server.store.gauges,
                          server.store.llhists):
                spare = table._spare
                if spare is not None:
                    leaf = spare["sum"] if isinstance(spare, dict) else spare
                    assert leaf.shape[0] == 3
            for s in (server, control):
                _feed(s, corpus(1))
            server.flush()  # delivers interval 1, swaps interval 2
            _assert_bit_identical(_flushed(obs.drain()), want1)
            control.flush()
            server.flush()  # delivers interval 2, swapped on 3 shards
            _assert_bit_identical(_flushed(obs.drain()),
                                  _flushed(cobs.drain()))
            _assert_ledger_clean(server)
        finally:
            _close(server, control)


# ---------------------------------------------------------------------------
# readiness, refusals, the query retry, the HTTP surface, telemetry
# ---------------------------------------------------------------------------


class TestReadyAndQuerySemantics:
    def test_begin_refuses_unsharded_and_busy(self):
        for make, err in ((mk_server, ReshardError),
                          (jmk_server, jreshard.ReshardError)):
            server, _ = make()
            try:
                with pytest.raises(err, match="not sharded"):
                    server.reshard.begin(shards=2)
            finally:
                _shutdown(server)
            server, _ = make(**{"tpu.shards": 2})
            try:
                with pytest.raises(err, match=">= 1"):
                    server.reshard.begin(shards=0)
                server.reshard.state = "planning"
                try:
                    with pytest.raises(err, match="in progress"):
                        server.reshard.begin(shards=3)
                finally:
                    server.reshard.state = "idle"
            finally:
                _shutdown(server)

    def test_ready_degrades_past_deadline(self):
        """/healthcheck/ready fails while a cutover is past its deadline
        and recovers when the state machine is idle again, with the JAX
        server's reason."""
        server, _ = mk_server(**{"tpu.shards": 2})
        jserver, _ = jmk_server(**{"tpu.shards": 2})
        try:
            for s in (server, jserver):
                assert s.ready_state()[0]
            reasons = []
            for s in (server, jserver):
                s.reshard.state = "cutover"
                s.reshard.deadline_unix = 1234567.0
                ok, reason = s.ready_state()
                assert not ok and "reshard" in reason
                reasons.append(reason)
                s.reshard.state = "idle"
                s.reshard.deadline_unix = 0.0
                assert s.ready_state()[0]
            assert reasons[0] == reasons[1]
        finally:
            _close(server, jserver)

    def test_query_mid_cutover_raises_typed_retry(self):
        """A capture during a cutover raises the typed retry, which is a
        QueryError (the alert loop's per-tick catch covers it)."""
        assert issubclass(ReshardRetry, QueryError)
        assert issubclass(JReshardRetry, JQueryError)
        server, _ = mk_server(**{"tpu.shards": 2})
        try:
            _feed(server, corpus(0))
            spec = QuerySpec.build(metric="rs.c.0", kind="count",
                                   tags=parse_tags("env:t"))
            server.reshard.state = "cutover"
            with pytest.raises(ReshardRetry, match="in progress"):
                server.query_plane.query(spec)
            server.alerts.configure([
                {"id": "r", "metric": "rs.c.0", "kind": "count",
                 "op": ">", "threshold": 0.5, "tags": "env:t"}])
            with pytest.raises(ReshardRetry):
                server.alerts.evaluate_once()
            server.reshard.state = "idle"
            assert server.alerts.evaluate_once() is not None
            assert server.query_plane.query(spec)["value"] is not None

            # a cutover that lands mid-capture: the tables' topology
            # epochs differ within one bundle
            quantile = QuerySpec.build(metric="rs.t.0", kind="quantile",
                                       q="0.5")
            assert server.query_plane.query(quantile)["value"] is not None
            server.store.llhists._topo_epoch += 1
            with pytest.raises(ReshardRetry, match="mid-capture"):
                server.query_plane.query(quantile)
        finally:
            _shutdown(server)

    def test_http_surface(self, tmp_path):
        """POST /reshard starts a live split (202), a second one while it
        runs is refused (409), a bad body answers 400; /debug/reshard
        reads the state machine; /query answers 503 + retry during a
        cutover; /metrics carries the reshard rows."""
        server, _obs = mk_server(**{"tpu.shards": 2},
                                 reshard_spool_dir=str(tmp_path / "wal"),
                                 chaos_enabled=True,
                                 chaos_reshard_prewarm_delay_s=0.5)
        api = None
        try:
            _feed(server, corpus(0))
            api = HTTPApi(server.config, server=server,
                          address="127.0.0.1:0")
            api.start()
            host, port = api.address

            def get(path):
                try:
                    with urllib.request.urlopen(
                            f"http://{host}:{port}{path}", timeout=10) as r:
                        return r.status, r.read()
                except urllib.error.HTTPError as e:
                    return e.code, e.read()

            def post(path, payload):
                req = urllib.request.Request(
                    f"http://{host}:{port}{path}",
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=10) as r:
                        return r.status, r.read()
                except urllib.error.HTTPError as e:
                    return e.code, e.read()

            status, body = get("/debug/reshard")
            assert status == 200
            assert json.loads(body)["state"] == "idle"

            server.reshard.state = "cutover"
            status, body = get("/query?metric=rs.c.0&kind=count&tags=env:t")
            assert status == 503
            assert json.loads(body)["retry"] is True
            server.reshard.state = "idle"

            status, body = post("/reshard", {"shards": 3})
            assert status == 202, body
            assert json.loads(body)["target_shards"] == 3
            status, body = post("/reshard", {"shards": 4})
            assert status == 409, body
            assert wait_until(lambda: server.reshard.epoch == 1
                              and server.reshard.state == "idle")
            assert server.store.shard_plane.n == 3
            status, body = get("/debug/reshard")
            state = json.loads(body)
            assert state["cutovers"] == 1 and state["shards"] == 3
            assert state["epoch"] == 1 and state["state"] == "idle"

            status, body = post("/reshard", {"shards": "bogus"})
            assert status == 400
            status, body = get("/metrics")
            assert status == 200
            assert b"reshard_epoch" in body and b"reshard_cutovers" in body
        finally:
            if api is not None:
                api.stop()
            _shutdown(server)

    def test_telemetry_rows_inventory(self):
        """The same reshard.* self-metrics and /debug/reshard keys as the
        JAX controller's."""
        server, _ = mk_server(**{"tpu.shards": 2})
        jserver, _ = jmk_server(**{"tpu.shards": 2})
        try:
            names = {row[0] for row in server.reshard.telemetry_rows()}
            assert names == {row[0] for row in
                             jserver.reshard.telemetry_rows()}
            assert names == {
                "reshard.state", "reshard.epoch", "reshard.cutovers",
                "reshard.last_cutover_seconds",
                "reshard.segments_written", "reshard.replayed_segments",
                "reshard.append_faults", "reshard.capture_failures",
                "reshard.device_losses", "reshard.inflight_metrics"}
            assert server.reshard.describe() == {
                k: v for k, v in jserver.reshard.describe().items()}
        finally:
            _close(server, jserver)

    def test_config_keys_read_like_jax(self, tmp_path):
        """The five reshard keys read like the JAX Config's: defaults,
        durations, the carryover spool fallback and the chaos plan."""
        from veneur_tpu.config import Config as JConfig
        from veneur_tpu_torch.util.chaos import Chaos
        jcfg = JConfig()
        cfg = config_from_dict({})
        for key in ("reshard_spool_dir", "reshard_deadline",
                    "chaos_reshard_prewarm_delay_s",
                    "chaos_reshard_append_fault_nth",
                    "chaos_reshard_cutover_delay_s"):
            assert getattr(cfg, key) == getattr(jcfg, key), key
        cfg = config_from_dict({"reshard_deadline": "1m30s",
                                "chaos_enabled": True,
                                "chaos_reshard_prewarm_delay_s": 0.25,
                                "chaos_reshard_append_fault_nth": 3,
                                "chaos_reshard_cutover_delay_s": 1.5})
        assert cfg.reshard_deadline == 90.0
        plan = Chaos.from_config(cfg)
        assert (plan.reshard_prewarm_delay_s, plan.reshard_append_fault_nth,
                plan.reshard_cutover_delay_s) == (0.25, 3, 1.5)
        server, _ = mk_server(**{"tpu.shards": 2},
                              carryover_spool_dir=str(tmp_path / "carry"))
        try:
            assert server.reshard.describe()["spool_dir"] == \
                str(tmp_path / "carry" / "reshard")
            assert server.reshard.describe()["durable"] is True
        finally:
            _shutdown(server)


# ---------------------------------------------------------------------------
# the SIGKILL soak (veneur_tpu_torch/cmd/reshard_soak.py)
# ---------------------------------------------------------------------------


def _run_port_soak(kills: int) -> dict:
    from veneur_tpu_torch.cmd import reshard_soak
    report = reshard_soak.run_soak(kills=kills, device="cpu")
    assert report["kills"] == kills and report["restarts"] == kills
    # nonempty, every round killed with range segments on disk, and
    # already diffed against the control inside run_soak
    assert all(r["rows"] > 0 and r["segments"] > 0
               for r in report["rounds"])
    return report


def test_sigkill_mid_cutover_one_round():
    """One round of the port's soak on the CPU: a sharded child SIGKILLed
    with its range segments durable and the merge held open in the chaos
    seam, restarted at the old shard count, replays; its flush equals
    the never-resharded control's under strict ledgers."""
    _run_port_soak(kills=1)


@pytest.mark.slow
class TestReshardSoak:
    def test_sigkill_mid_cutover_soak(self):
        """The multi-round soak, as tests/test_reshard.py's."""
        _run_port_soak(kills=3)
