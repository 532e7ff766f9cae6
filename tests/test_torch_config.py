"""The port's configuration against the JAX package's: the VENEUR_*
environment overlay, the read-buffer default, the lifecycle, sources,
observatory and overlapped-flush keys, and the JAX keys the port lacks,
which raise by name from the environment as they do from a file."""

from __future__ import annotations

import dataclasses

import pytest

from veneur_tpu import config as jax_config
from veneur_tpu_torch import config as port_config

_YAML = ("interval: 5s\n"
         "percentiles: [0.5, 0.99]\n"
         "metric_sinks:\n"
         "  - kind: blackhole\n"
         "    name: bh\n"
         "extend_tags: ['env:test']\n")


def _plain(value):
    """A config value in a form both packages' values compare in: a
    dataclass as a dict of its fields, a secret by its value."""
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if hasattr(value, "reveal"):
        return value.reveal()
    if isinstance(value, list):
        return [_plain(v) for v in value]
    return value


def _assert_same(port_cfg, jax_cfg) -> int:
    """Every field the two packages share, equal; a block's shared
    fields likewise. Returns the fields compared."""
    jax_names = {f.name for f in dataclasses.fields(jax_cfg)}
    compared = 0
    for f in dataclasses.fields(port_cfg):
        if f.name not in jax_names:
            continue
        got = _plain(getattr(port_cfg, f.name))
        want = _plain(getattr(jax_cfg, f.name))
        if isinstance(got, dict) and isinstance(want, dict):
            shared = got.keys() & want.keys()
            got = {k: got[k] for k in shared}
            want = {k: want[k] for k in shared}
        assert got == want, f.name
        compared += 1
    return compared


@pytest.mark.parametrize("text, env", [
    # tests/test_server.py::TestConfig::test_yaml_and_env
    (_YAML, {"VENEUR_INTERVAL": "30s", "VENEUR_DEBUG": "true"}),
    # tests/test_server.py::TestNestedEnvOverlay::test_tpu_fields_from_env
    ("interval: 5s\n", {"VENEUR_TPU_HISTO_CAPACITY": "12345",
                        "VENEUR_TPU_DISABLE_NATIVE_PARSER": "true",
                        "VENEUR_INTERVAL": "20s"}),
    # ::test_empty_tpu_section_tolerated
    ("interval: 5s\ntpu:\n", {"VENEUR_TPU_SET_CAPACITY": "777"}),
    # every coercion: int, float, bool, list, percentiles, duration,
    # string, secret, and a lifecycle key of each block
    ("hostname: h\n", {"VENEUR_NUM_READERS": "3",
                       "VENEUR_CHAOS_ERROR_RATE": "0.25",
                       "VENEUR_FORWARD_ONLY": "yes",
                       "VENEUR_EXTEND_TAGS": "a:1,b:2",
                       "VENEUR_PERCENTILES": "0.5,0.9",
                       "VENEUR_SUPERVISOR_DEADLINE": "1500ms",
                       "VENEUR_FORWARD_ADDRESS": "127.0.0.1:8128",
                       "VENEUR_TLS_KEY": "secret-key",
                       "VENEUR_COUNT_UNIQUE_TIMESERIES": "1",
                       "VENEUR_TPU_IDLE_KEY_INTERVALS": "2",
                       "VENEUR_TPU_MAX_ROWS_PER_FAMILY": "1000",
                       "VENEUR_RESHARD_DEADLINE": "45s",
                       "VENEUR_RESHARD_SPOOL_DIR": "/var/spool/reshard",
                       "VENEUR_CHAOS_RESHARD_APPEND_FAULT_NTH": "3",
                       "VENEUR_CHAOS_RESHARD_CUTOVER_DELAY_S": "0.5",
                       "VENEUR_NOT_A_KEY": "ignored",
                       "PATH": "/bin"}),
    # the observatory and overlapped-flush keys, from the file and from
    # the environment
    ("flush_async: true\nprewarm_ladder: true\n"
     "latency_observatory: false\ncardinality_soft_limit: 2000\n"
     "cardinality_hard_limit: 10000\ncardinality_degraded_keep: 0.1\n",
     {"VENEUR_CARDINALITY_TOP_K": "64",
      "VENEUR_CARDINALITY_HLL_NAMES": "4",
      "VENEUR_CARDINALITY_HLL_MIN_MINTS": "128",
      "VENEUR_CARDINALITY_DEGRADED_KEEP": "0.25"}),
    ("", {"VENEUR_FLUSH_ASYNC": "true", "VENEUR_PREWARM_LADDER": "1",
          "VENEUR_LATENCY_OBSERVATORY": "false",
          "VENEUR_CARDINALITY_SOFT_LIMIT": "5",
          "VENEUR_CARDINALITY_HARD_LIMIT": "9"}),
    # the device observatory, profiling and crash-reporting keys
    ("enable_profiling: true\nsentry_dsn: https://k@sentry.invalid/1\n",
     {"VENEUR_DEVICE_OBSERVATORY": "false",
      "VENEUR_OVERLOAD_DEVICE_SOFT_BYTES": "100",
      "VENEUR_OVERLOAD_DEVICE_HARD_BYTES": "200",
      "VENEUR_PROFILE_SERVER_PORT": "6060",
      "VENEUR_BLOCK_PROFILE_RATE": "1",
      "VENEUR_MUTEX_PROFILE_FRACTION": "2"}),
    # the environment under an empty file, and the defaults alone
    ("", {"VENEUR_HOSTNAME": "from-env"}),
    ("", {}),
])
def test_env_overlay_matches_jax(tmp_path, text, env):
    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    port_cfg = port_config.read_config(str(path), env=env)
    jax_cfg = jax_config.read_config(str(path), env=env)
    assert _assert_same(port_cfg, jax_cfg) == 119
    assert _assert_same(port_cfg.tpu, jax_cfg.tpu) == 13


def test_the_yaml_and_env_case_field_values(tmp_path):
    """The values test_server.py pins, on the port."""
    path = tmp_path / "cfg.yaml"
    path.write_text(_YAML)
    cfg = port_config.read_config(str(path), env={
        "VENEUR_INTERVAL": "30s", "VENEUR_DEBUG": "true"})
    assert cfg.interval == 30.0
    assert cfg.debug is True
    assert cfg.percentiles == [0.5, 0.99]
    assert cfg.metric_sinks[0].kind == "blackhole"
    assert cfg.is_local is False


def test_read_config_reads_os_environ(tmp_path, monkeypatch):
    path = tmp_path / "cfg.yaml"
    path.write_text("interval: 5s\n")
    monkeypatch.setenv("VENEUR_INTERVAL", "7s")
    monkeypatch.setenv("VENEUR_TPU_COUNTER_CAPACITY", "99")
    cfg = port_config.read_config(str(path))
    assert cfg.interval == 7.0 and cfg.tpu.counter_capacity == 99
    assert jax_config.read_config(str(path)).interval == 7.0


def test_env_overlay_precedes_the_defaults(tmp_path):
    """The defaults follow the overlay, as in the JAX package: a span
    channel raised from the environment sizes the sink queue."""
    path = tmp_path / "cfg.yaml"
    path.write_text("")
    env = {"VENEUR_SPAN_CHANNEL_CAPACITY": "1000", "VENEUR_INTERVAL": "0s"}
    port_cfg = port_config.read_config(str(path), env=env)
    jax_cfg = jax_config.read_config(str(path), env=env)
    assert port_cfg.span_sink_queue_capacity == 8000
    assert port_cfg.span_sink_queue_capacity == \
        jax_cfg.span_sink_queue_capacity
    assert port_cfg.interval == jax_cfg.interval == 10.0


@pytest.mark.parametrize("name", [
    "VENEUR_CHAOS_RESHARD_APPEND_FAULT_NTH", "VENEUR_Reshard_Deadline",
    "VENEUR_RESHARD_DEADLINE", "VENEUR_RESHARD_SPOOL_DIR",
    "VENEUR_JAX_COMPILATION_CACHE_DIR",
    "VENEUR_CHAOS_RESHARD_CUTOVER_DELAY_S",
    "VENEUR_CHAOS_RESHARD_PREWARM_DELAY_S",
    "VENEUR_TPU_SHARDS", "VENEUR_TPU_SHARD_ROUTING",
    "VENEUR_TPU_PALLAS_TDIGEST_FLUSH"])
def test_env_naming_a_jax_only_key_raises_by_name(tmp_path, name):
    """A JAX key the port lacks raises by name from the environment;
    `tpu.shards` and `tpu.shard_routing`, ported since, raise by name on
    a value out of their range; the reshard keys, ported with the
    elastic reshard, are read from it as the JAX package reads them."""
    path = tmp_path / "cfg.yaml"
    path.write_text("interval: 5s\n")
    key = name[len("VENEUR_"):].lower()
    if "reshard" in key:
        value = "45s" if "deadline" in key else "2"
        # the port's overlay matches a name in any case, the JAX
        # package's the upper-case name only
        assert getattr(port_config.read_config(
            str(path), env={name: value}), key) == getattr(
            jax_config.read_config(str(path),
                                   env={name.upper(): value}), key)
        return
    if key.startswith("tpu_"):
        key = key[len("tpu_"):]
    value = {"VENEUR_TPU_SHARDS": "129",
             "VENEUR_TPU_SHARD_ROUTING": "modulo"}.get(name, "1")
    with pytest.raises(ValueError, match=key):
        port_config.read_config(str(path), env={name: value})


@pytest.mark.parametrize("name", ["VENEUR_METRIC_SINKS", "VENEUR_SOURCES",
                                  "VENEUR_FEATURES", "VENEUR_TPU",
                                  "VENEUR_VENEUR_METRICS_SCOPES"])
def test_env_cannot_set_a_structured_key(tmp_path, name):
    path = tmp_path / "cfg.yaml"
    path.write_text("")
    with pytest.raises(ValueError, match="environment"):
        port_config.read_config(str(path), env={name: "x"})


@pytest.mark.parametrize("value", [0, -1])
def test_read_buffer_size_defaults_like_jax(tmp_path, value):
    path = tmp_path / "cfg.yaml"
    path.write_text(f"read_buffer_size_bytes: {value}\n")
    port_cfg = port_config.read_config(str(path), env={})
    jax_cfg = jax_config.read_config(str(path), env={})
    assert port_cfg.read_buffer_size_bytes == 2 * 1024 * 1024
    assert port_cfg.read_buffer_size_bytes == jax_cfg.read_buffer_size_bytes
    env_cfg = port_config.read_config(
        str(path), env={"VENEUR_READ_BUFFER_SIZE_BYTES": str(value)})
    assert env_cfg.read_buffer_size_bytes == 2 * 1024 * 1024
    assert port_config.config_from_dict(
        {"read_buffer_size_bytes": value}).read_buffer_size_bytes == \
        2 * 1024 * 1024


def test_sources_and_lifecycle_keys_parse_like_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "count_unique_timeseries: true\n"
        "debug: true\n"
        "tpu: {idle_key_intervals: 3, max_rows_per_family: 500}\n"
        "sources:\n"
        "  - kind: otlp\n"
        "    name: collector\n"
        "    tags: ['team:obs']\n"
        "    config: {listen_address: '127.0.0.1:0'}\n"
        "  - kind: openmetrics\n"
        "    config: {url: 'http://127.0.0.1:1/metrics',"
        " scrape_interval: 1s}\n")
    port_cfg = port_config.read_config(str(path), env={})
    jax_cfg = jax_config.read_config(str(path), env={})
    _assert_same(port_cfg, jax_cfg)
    assert port_cfg.sources[0].tags == ["team:obs"]
    assert port_cfg.tpu.idle_key_intervals == 3
    defaults = port_config.Config()
    assert defaults.tpu.idle_key_intervals == \
        jax_config.Config().tpu.idle_key_intervals == 5
    assert defaults.tpu.max_rows_per_family == \
        jax_config.Config().tpu.max_rows_per_family == 2_000_000


_SLICE12_KEYS = ("flush_async", "prewarm_ladder", "latency_observatory",
                 "cardinality_soft_limit", "cardinality_hard_limit",
                 "cardinality_degraded_keep", "cardinality_top_k",
                 "cardinality_hll_names", "cardinality_hll_min_mints")


@pytest.mark.parametrize("key", _SLICE12_KEYS)
def test_observatory_and_async_keys_default_and_load_like_jax(tmp_path,
                                                              key):
    """Each of the nine keys: the JAX default, and a value from the
    environment over a file value, field by field like the JAX
    read_config."""
    assert getattr(port_config.Config(), key) == \
        getattr(jax_config.Config(), key)
    default = getattr(jax_config.Config(), key)
    file_value, env_value = {bool: (not default, default),
                             int: (7, 11), float: (0.5, 0.125)}[
        type(default)]
    path = tmp_path / "cfg.yaml"
    path.write_text(f"{key}: {str(file_value).lower()}\n")
    for env in ({}, {f"VENEUR_{key.upper()}": str(env_value).lower()}):
        port_cfg = port_config.read_config(str(path), env=env)
        jax_cfg = jax_config.read_config(str(path), env=env)
        assert getattr(port_cfg, key) == getattr(jax_cfg, key) == (
            env_value if env else file_value)
    assert key not in port_config._JAX_ONLY_KEYS


def test_unknown_source_entry_key_raises():
    with pytest.raises(ValueError, match="sources.*bogus"):
        port_config.config_from_dict(
            {"sources": [{"kind": "otlp", "bogus": 1}]})
