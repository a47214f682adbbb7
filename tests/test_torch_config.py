"""Port vs reference: the circuit-shape config files (``config.py``).

The cases of ``tests/test_config.py`` on the port's copy: the reference
schema, ``ZKDCAP_CONFIG`` selection, the default file, ``load_sweep`` on
``configs/bench_ecdsa.config``, the CLI's ``--config`` and ``validate``'s
rejections; ``to_json`` and the loaded configs equal the JAX package's.
"""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from zkdcap_tpu import config as jconfig  # noqa: E402
from zkdcap_tpu_torch import config  # noqa: E402
from zkdcap_tpu_torch.config import CircuitConfig, load_config, load_sweep  # noqa: E402

REF_LINE = ('{"strategy":"Simple","degree":17,"num_advice":4,'
            '"num_lookup_advice":1,"num_fixed":1,"lookup_bits":16,'
            '"limb_bits":88,"num_limbs":3}')


def _same(cfg, j_cfg) -> bool:
    return dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg) and cfg.to_json() == j_cfg.to_json()


def test_module_constants_equal_reference():
    assert config.ENV_VAR == jconfig.ENV_VAR == "ZKDCAP_CONFIG"
    assert Path(config.DEFAULT_PATH).resolve() == Path(jconfig.DEFAULT_PATH).resolve() \
        == ROOT / "configs" / "ecdsa_circuit.config"
    assert [f.name for f in dataclasses.fields(CircuitConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.CircuitConfig)]


def test_reference_schema_parses():
    cfg = CircuitConfig.from_json(REF_LINE)
    assert cfg.degree == 17 and cfg.lookup_bits == 16
    assert cfg.num_advice == 4  # kept as an expectation
    cfg.validate()
    assert _same(cfg, jconfig.CircuitConfig.from_json(REF_LINE))


@pytest.mark.parametrize("line", [REF_LINE, '{"degree":14,"lookup_bits":13,"unknown":1}',
                                  '{"degree":18,"lookup_bits":17,"multiopen":"gwc",'
                                  '"transcript":"keccak","num_fixed":null}'])
def test_to_json_equals_reference(line):
    cfg = CircuitConfig.from_json(line)
    assert cfg.to_json() == jconfig.CircuitConfig.from_json(line).to_json()
    assert CircuitConfig.from_json(cfg.to_json()) == cfg


def test_env_var_selection(tmp_path, monkeypatch):
    p = tmp_path / "my.config"
    p.write_text('{"degree":14,"lookup_bits":13}\n')
    monkeypatch.setenv("ZKDCAP_CONFIG", str(p))
    cfg = load_config()
    assert cfg.degree == 14 and cfg.lookup_bits == 13
    assert _same(cfg, jconfig.load_config())


def test_explicit_path_beats_env_var(tmp_path, monkeypatch):
    env, explicit = tmp_path / "env.config", tmp_path / "explicit.config"
    env.write_text('{"degree":14,"lookup_bits":13}\n')
    explicit.write_text('{"degree":16,"lookup_bits":15,"multiopen":"gwc"}\n')
    monkeypatch.setenv("ZKDCAP_CONFIG", str(env))
    cfg = load_config(str(explicit))
    assert (cfg.degree, cfg.multiopen) == (16, "gwc")
    assert _same(cfg, jconfig.load_config(str(explicit)))


def test_default_config_file(monkeypatch):
    monkeypatch.delenv("ZKDCAP_CONFIG", raising=False)
    cfg = load_config()
    assert cfg.degree == 18 and cfg.lookup_bits == 17  # configs/ecdsa_circuit.config
    assert _same(cfg, jconfig.load_config())


def test_sweep_loader():
    path = str(ROOT / "configs" / "bench_ecdsa.config")
    sweep = load_sweep(path)
    assert [c.degree for c in sweep] == [18, 17, 16, 15, 14, 13, 12]
    for c in sweep:
        c.validate()
    assert all(_same(c, j) for c, j in zip(sweep, jconfig.load_sweep(path), strict=True))


def test_cli_accepts_config(tmp_path):
    from zkdcap_tpu_torch.cli import main

    p = tmp_path / "cfg.config"
    p.write_text('{"degree":13,"lookup_bits":12}\n')
    # the params-dir guard still fires with a config given and no params dir
    with pytest.raises(SystemExit) as e:
        main(["--params-dir", str(tmp_path / "nope"), "--config", str(p),
              "verify", "--msghash", "0x00", "--signature", "0x00",
              "--pubkey", "0x00", "--proof", "0x00"])
    assert e.value.code == 2


@pytest.mark.parametrize("fields,match", [
    ({"degree": 17, "lookup_bits": 16, "num_limbs": 4}, "3 limbs"),
    ({"degree": 17, "lookup_bits": 16, "limb_bits": 64}, "limb_bits"),
    ({"degree": 12, "lookup_bits": 12}, "lookup table"),
    ({"degree": 17, "lookup_bits": 16, "multiopen": "ipa"}, "multiopen"),
])
def test_validate_rejects_bad_values(fields, match):
    """validate() raises ValueError (not assert: survives python -O) for
    values outside the reference instance-encoding contract, with the JAX
    package's message."""
    with pytest.raises(ValueError, match=match) as got:
        CircuitConfig(**fields).validate()
    with pytest.raises(ValueError) as want:
        jconfig.CircuitConfig(**fields).validate()
    assert str(got.value) == str(want.value)
