"""The port's ``DYN_KV_*`` environment (``engine/config.py``
``env_overrides``, read by the CLI) against the JAX package's env table:
``DYN_KV_STORE`` takes every spelling to the value the JAX config takes,
a malformed value raises the JAX message, and an unknown ``DYN_KV_*``
name raises naming the accepted spellings. The JAX package's other
knobs (``DYN_KV_PACKING``, ``DYN_KV_PREFETCH``, ``DYN_KV_PROACTIVE``,
``DYN_SPEC``) are not the port's: the first three are refused as
unknown and ``DYN_SPEC`` is not read. A config built in code reads no
environment. Tolerance: none; values and messages compare exactly."""

import pytest

from dynamo_exp_tpu.engine import config as jconfig
from dynamo_exp_tpu.models import TINY as JTINY
from dynamo_exp_tpu_torch.engine import config as tconfig
from dynamo_exp_tpu_torch.models import TINY

ACCEPTED = ("DYN_KV_DEFAULT_BW_BPS", "DYN_KV_STORE")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    import os

    for name in list(os.environ):
        if name.startswith(("DYN_KV_", "DYN_SPEC")):
            monkeypatch.delenv(name)


def jax_outcome(**kw):
    try:
        return jconfig.EngineConfig(model=JTINY, **kw).kv_store_dir
    except ValueError as e:
        return ("error", str(e))


def port_outcome():
    try:
        return tconfig.env_overrides().get("kv_store_dir", "")
    except ValueError as e:
        return ("error", str(e))


def test_the_store_row_is_the_jax_tables():
    (name, attr), = tconfig._ENV_KNOBS
    assert (name, attr, "path") in jconfig._ENV_KNOBS
    assert set(tconfig._ENV_FAMILIES) < set(jconfig._ENV_FAMILIES)
    assert tconfig._ENV_EXEMPT == jconfig._ENV_EXEMPT
    assert tconfig._TRUTHY == jconfig._TRUTHY and tconfig._FALSY == jconfig._FALSY


@pytest.mark.parametrize("name,value", [
    ("DYN_KV_STORE", "/tmp/g3-store"), ("DYN_KV_STORE", "  /tmp/g3-store  "),
    ("DYN_KV_STORE", "off"), ("DYN_KV_STORE", "0"), ("DYN_KV_STORE", "No"),
    ("DYN_KV_STORE", ""), ("DYN_KV_DEFAULT_BW_BPS", "1e9"),
])
def test_each_spelling_sets_what_jax_sets(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    got = port_outcome()
    assert got == jax_outcome()
    assert not isinstance(got, tuple)


@pytest.mark.parametrize("value", ["1", "true", "ON", "yes"])
def test_a_bare_flag_raises_the_jax_message(monkeypatch, value):
    monkeypatch.setenv("DYN_KV_STORE", value)
    got = port_outcome()
    assert got == jax_outcome() and got[0] == "error"


@pytest.mark.parametrize("name", [
    "DYN_KV_PACKNG", "DYN_KV_", "DYN_KV_STOR",
    "DYN_KV_PACKING", "DYN_KV_PREFETCH", "DYN_KV_PROACTIVE",
])
def test_unknown_names_raise_naming_the_accepted_spellings(monkeypatch, name):
    monkeypatch.setenv(name, "1")
    got = port_outcome()
    assert got[0] == "error" and repr(name) in got[1]
    for accepted in ACCEPTED:
        assert accepted in got[1]


def test_dyn_spec_is_not_read(monkeypatch):
    monkeypatch.setenv("DYN_SPEC", "ngram")
    assert tconfig.env_overrides() == {}
    assert tconfig.EngineConfig(model=TINY).spec_mode == "off"


def test_a_config_built_in_code_reads_no_environment(monkeypatch):
    monkeypatch.setenv("DYN_KV_STORE", "/tmp/g3-store")
    monkeypatch.setenv("DYN_KV_PACKNG", "1")
    assert tconfig.EngineConfig(model=TINY).kv_store_dir == ""
    cfg = tconfig.EngineConfig(model=TINY, kv_store_dir="/tmp/mine", kv_packing=False)
    assert cfg.kv_store_dir == "/tmp/mine" and cfg.kv_packing is False


def test_the_store_needs_pages_as_in_jax():
    for pages in (0, -1):
        with pytest.raises(ValueError) as err:
            tconfig.EngineConfig(model=TINY, kv_store_dir="/x", kv_store_pages=pages)
        assert ("error", str(err.value)) == jax_outcome(kv_store_dir="/x",
                                                         kv_store_pages=pages)


def test_cli_takes_the_store_and_exits_naming_the_accepted_spellings(monkeypatch):
    from dynamo_exp_tpu_torch import run

    monkeypatch.setenv("DYN_KV_STORE", "/tmp/g3-store")
    opts = run.parse_args(["in=http", "out=echo_core"])
    assert opts.engine_env == {"kv_store_dir": "/tmp/g3-store"}
    monkeypatch.setenv("DYN_KV_PACKNG", "1")
    with pytest.raises(SystemExit) as err:
        run.parse_args(["in=http", "out=echo_core"])
    for name in ACCEPTED:
        assert name in str(err.value.code)


CLI_CASES = [
    ("DYN_KV_STORE", v) for v in ("/tmp/g3-store", "  /tmp/g3-store  ", "off", "0", "No", "",
                                   "1", "true", "ON", "yes")
] + [(name, "1") for name in ("DYN_KV_PACKNG", "DYN_KV_", "DYN_KV_STOR", "DYN_KV_PACKING",
                               "DYN_KV_PREFETCH", "DYN_KV_PROACTIVE")] + [
    ("DYN_KV_DEFAULT_BW_BPS", "1e9")]


@pytest.mark.parametrize("name,value", CLI_CASES)
def test_the_cli_takes_what_env_overrides_takes(monkeypatch, name, value):
    """``run.parse_args`` carries ``env_overrides()`` as ``engine_env``,
    or exits with its message."""
    from dynamo_exp_tpu_torch import run

    monkeypatch.setenv(name, value)
    try:
        want = tconfig.env_overrides()
    except ValueError as e:
        with pytest.raises(SystemExit) as err:
            run.parse_args(["in=http", "out=echo_core"])
        assert str(err.value.code) == str(e)
        return
    assert run.parse_args(["in=http", "out=echo_core"]).engine_env == want


def test_the_cli_engine_arms_g3_from_dyn_kv_store(monkeypatch, tmp_path):
    """``out=cuda`` with ``DYN_KV_STORE`` and a host tier serves an engine
    over that store; without the variable, none."""
    from dynamo_exp_tpu_torch import run
    from tests.fixtures import build_tiny_model_dir

    model_dir = build_tiny_model_dir(str(tmp_path / "model"))
    argv = ["in=http", "out=cuda", "--device", "cpu", "--model-path", model_dir,
            "--random-weights", "--max-decode-slots", "2", "--page-size", "8",
            "--max-model-len", "64", "--num-pages", "32", "--host-cache-pages", "8",
            "--kv-dtype", "float32"]
    monkeypatch.setenv("DYN_KV_STORE", str(tmp_path / "g3"))
    engine, _ = run.build_cuda_engine(run.parse_args(argv))
    try:
        assert engine.cfg.kv_store_dir == str(tmp_path / "g3")
        assert engine.g3_store is not None and (tmp_path / "g3").is_dir()
    finally:
        engine.stop()
    monkeypatch.delenv("DYN_KV_STORE")
    engine, _ = run.build_cuda_engine(run.parse_args(argv))
    try:
        assert engine.cfg.kv_store_dir == "" and engine.g3_store is None
    finally:
        engine.stop()
