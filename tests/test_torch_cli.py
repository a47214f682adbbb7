"""Port vs reference: the prover CLI (``zkdcap_tpu_torch/cli.py``).

The port's CLI with ``--device cpu`` against the JAX package's
``zkdcap_tpu/cli.py``: every subcommand's arguments parse and a missing
params dir exits with 2 and the JAX message; ``gen-calldata`` prints the
JAX CLI's calldata; ``gen-solidity --output`` writes the JAX CLI's file;
``verify --evm`` executes the generated contract on the JAX package's
keccak proof of the reference vector (``proof_keccak`` of
``testdata/p256_proof.json``): ``valid`` and exit 0, and ``INVALID`` and
exit 1 with a byte flipped; ``--shards 2`` reaches the provers, which prove
over a mesh of two CPU shards;
without ``--device`` on a machine with no card a proving command raises
instead of running on the CPU; the ``--input`` JSON readers of the
cert-chain and quote commands give the JAX CLI's inputs.
"""

import dataclasses
import json
import shutil
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from zkdcap_tpu import cli as jcli  # noqa: E402
from zkdcap_tpu_torch import cli  # noqa: E402

ASSETS = ROOT / "assets"
FIXTURE = json.loads((ROOT / "zkdcap_tpu_torch" / "testdata" / "p256_proof.json").read_text())
ECDSA = ["--msghash", "0x" + FIXTURE["msghash"], "--signature", "0x" + FIXTURE["signature"],
         "--pubkey", "0x" + FIXTURE["pubkey"]]
# every subcommand with its required arguments
SUBCOMMANDS = {
    "prove": ["prove", *ECDSA, "--evm"],
    "verify": ["verify", *ECDSA, "--proof", "0x00", "--evm"],
    "gen-calldata": ["gen-calldata", *ECDSA, "--proof", "0x00"],
    "gen-solidity": ["gen-solidity"],
    "dcap-mock": ["dcap-mock"],
    "dcap-prove": ["dcap-prove"],
    "dcap-verify": ["dcap-verify", "--proof", "0x00"],
    "cert-chain-prove": ["cert-chain-prove"],
    "cert-chain-verify": ["cert-chain-verify", "--proof", "0x00"],
    "quote-prove": ["quote-prove"],
    "quote-verify": ["quote-verify", "--proof", "0x00"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params_dir(tmp_path_factory):
    """A params dir holding the committed vk and pinning, as the JAX
    package's ``setup`` writes them."""
    params = tmp_path_factory.mktemp("params")
    shutil.copy(ASSETS / "vk_k18.json", params / "vk_k18.json")
    shutil.copy(ASSETS / "pinning_k18.json", params / "pinning.json")
    return params


def _run(main, argv, capsys):
    """Run a CLI's main: (exit code, stdout, stderr); 0 when it returns."""
    code = 0
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    captured = capsys.readouterr()
    return code, captured.out, captured.err


@pytest.mark.parametrize("name", list(SUBCOMMANDS))
def test_missing_params_dir_exits_2_like_reference(tmp_path, capsys, name):
    argv = ["--params-dir", str(tmp_path / "nope"), *SUBCOMMANDS[name]]
    got = _run(cli.main, ["--device", "cpu", *argv], capsys)
    assert got == _run(jcli.main, argv, capsys)
    assert got[0] == 2 and "does not exist; run `zk-clique setup` first" in got[2]


def test_gen_calldata_equals_reference(params_dir, capsys):
    argv = ["--params-dir", str(params_dir), "gen-calldata", *ECDSA,
            "--proof", "0x" + FIXTURE["proof_keccak"]]
    got = _run(cli.main, ["--device", "cpu", *argv], capsys)
    assert got == _run(jcli.main, argv, capsys)
    assert got[0] == 0 and got[1].startswith("0x") and len(got[1].strip()) == \
        2 + 2 * (32 * 15 + len(FIXTURE["proof_keccak"]) // 2)


def test_hex_arguments_from_files(params_dir, tmp_path, capsys):
    """Arguments accept file paths as well as 0x-literals."""
    files = []
    for key in ("msghash", "signature", "pubkey", "proof_keccak"):
        f = tmp_path / f"{key}.hex"
        f.write_text("0x" + FIXTURE[key] + "\n")
        files.append(str(f))
    argv = ["--device", "cpu", "--params-dir", str(params_dir), "gen-calldata"]
    literal = _run(cli.main, [*argv, *ECDSA, "--proof", "0x" + FIXTURE["proof_keccak"]], capsys)
    from_files = _run(cli.main, [*argv, "--msghash", files[0], "--signature", files[1],
                                 "--pubkey", files[2], "--proof", files[3]], capsys)
    assert from_files == literal


def test_gen_solidity_output_equals_reference(params_dir, tmp_path, capsys):
    ours, ref = tmp_path / "port.sol", tmp_path / "jax.sol"
    base = ["--params-dir", str(params_dir), "gen-solidity", "--output"]
    assert _run(cli.main, ["--device", "cpu", *base, str(ours)], capsys)[:2] == \
        (0, f"verifier written to {ours}\n")
    assert _run(jcli.main, [*base, str(ref)], capsys)[:2] == (0, f"verifier written to {ref}\n")
    assert ours.read_text() == ref.read_text()


def test_verify_evm_executes_the_contract(params_dir, tmp_path, capsys):
    proof = bytes.fromhex(FIXTURE["proof_keccak"])
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    (tmp_path / "bad.hex").write_text("0x" + bytes(bad).hex())
    base = ["--device", "cpu", "--params-dir", str(params_dir), "verify", "--evm", *ECDSA]
    assert _run(cli.main, [*base, "--proof", "0x" + proof.hex()], capsys)[:2] == (0, "valid\n")
    assert _run(cli.main, [*base, "--proof", str(tmp_path / "bad.hex")], capsys)[:2] == \
        (1, "INVALID\n")
    # the bytecode is cached in the params dir under the JAX package's name
    assert (params_dir / "evm_verifier_k18_shplonk.bin").is_file()


def test_shards_raise_not_ported(params_dir, capsys, monkeypatch):
    """``--shards 2`` reaches the provers as ``shards=2``: each proves over a
    mesh of two CPU shards (the preparation and the proof stubbed)."""
    from types import SimpleNamespace

    from zkdcap_tpu_torch.parallel import Mesh
    from zkdcap_tpu_torch.runtime import circuit_prover
    from zkdcap_tpu_torch.runtime import prover as runtime_prover

    meshes = []
    pk = SimpleNamespace(vk=SimpleNamespace(transcript_kind="blake2b"))
    for module, cls in ((runtime_prover, runtime_prover.ECDSAProver),
                        (circuit_prover, circuit_prover.CircuitProver)):
        monkeypatch.setattr(cls, "prepare",
                            lambda self, inp, timing=False: (pk, [], [[0] * 15]))
        monkeypatch.setattr(cls, "params", lambda self: None)
        monkeypatch.setattr(module, "create_proof",
                            lambda *args, mesh=None, **kw: meshes.append(mesh) or b"\xab")
    for argv in (["prove", *ECDSA], ["dcap-prove"]):
        code, out, _ = _run(cli.main, ["--device", "cpu", "--params-dir", str(params_dir),
                                       "--shards", "2", *argv], capsys)
        assert (code, out) == (0, "0xab\n")
    assert len(meshes) == 2
    for mesh in meshes:
        assert isinstance(mesh, Mesh) and mesh.devices == [torch.device("cpu")] * 2


def test_no_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    for argv in (["setup"], ["prove", *ECDSA]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--params-dir", str(tmp_path / "params"), *argv])
    assert not list((tmp_path / "params").glob("pk_*"))


def test_module_runs_as_a_program(tmp_path):
    """``python -m zkdcap_tpu_torch.cli``: the guard's exit code and message."""
    proc = subprocess.run([sys.executable, "-m", "zkdcap_tpu_torch.cli", "--device", "cpu",
                           "--params-dir", str(tmp_path / "nope"), "gen-solidity"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stderr.strip() == f"`{tmp_path / 'nope'}` does not exist; run `zk-clique setup` first"


def _as_plain(v):
    """A structure input as plain data, comparable across the packages."""
    return json.loads(json.dumps(dataclasses.asdict(v), default=lambda b: b.hex()))


def _hexed(v):
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, int):
        return hex(v)
    return [_hexed(x) for x in v]


@pytest.mark.parametrize("kind", ["cert_chain", "quote"])
def test_input_json_readers_equal_reference(tmp_path, kind):
    from zkdcap_tpu.circuits.cert_chain import make_intel_demo_chain
    from zkdcap_tpu.circuits.quote import make_demo_quote

    reader, j_reader = {"cert_chain": (cli._chain_input, jcli._chain_input),
                        "quote": (cli._quote_input, jcli._quote_input)}[kind]
    # the defaults: the demo inputs
    assert _as_plain(reader(Namespace(input=None))) == _as_plain(j_reader(Namespace(input=None)))
    # a JSON file in the readers' layout, from another seed's demo input
    if kind == "cert_chain":
        demo = make_intel_demo_chain(seed=7)
        data = {"links": [{"tbs": "0x" + link.tbs.hex(), "r": hex(link.r), "s": hex(link.s),
                           "pubkey_offset": link.pubkey_offset} for link in demo.links],
                "root_pubkey": _hexed(demo.root_pubkey)}
    else:
        demo = make_demo_quote(seed=7)
        data = {f.name: _hexed(getattr(demo, f.name)) for f in dataclasses.fields(demo)}
    path = tmp_path / "input.json"
    path.write_text(json.dumps(data))
    got = reader(Namespace(input=str(path)))
    assert _as_plain(got) == _as_plain(j_reader(Namespace(input=str(path)))) == _as_plain(demo)
    assert got.verify_native()
