"""`zk-clique`-equivalent command line (reference bin/src/main.rs:31-108).

Subcommands (mirroring the reference's `p256-ecdsa` subcommand set):
  setup         keygen at k=18, writing params/ artifacts (main.rs:191)
  prove         --msghash --signature --pubkey [--evm] -> proof hex (main.rs:142-160)
  verify        --proof --msghash --signature --pubkey [--evm] (main.rs:123-139)
  gen-calldata  EVM calldata = instances ++ proof (main.rs:171)
  gen-solidity  Solidity verifier source (main.rs:181-189)
  dcap-mock     run the DCAP demo circuit through the constraint checker
  dcap-prove / dcap-verify            full DCAP proof lifecycle (k=17)
  cert-chain-prove / cert-chain-verify  roadmap: CA-chain circuit (2xECDSA+SHA)
  quote-prove / quote-verify            roadmap: full-quote circuit (README.md:23-46)

Arguments accept 0x-literals or file paths (read_raw_or_file, main.rs:111-120).

Port of ``zkdcap_tpu/cli.py``: the same program, subcommands, arguments,
messages, outputs and exit codes, and a global ``--device`` (default: the
card). Every prover runs on that device; with no card and no ``--device``
the prover raises, and the CLI never falls back to the CPU. The CUDA kernels
are built at their first use into ``build/``. ``--shards N`` proves over a
mesh of N shards (N CPU shards with ``--device cpu``, else N cards,
``--device``'s first; fewer raise). Run it with
``python -m zkdcap_tpu_torch.cli``.
"""

from __future__ import annotations

import argparse
import os
import sys


def _read_raw_or_file(v: str) -> str:
    if v.startswith("0x"):
        return v[2:]
    if os.path.exists(v):
        with open(v) as f:
            return f.read().strip().removeprefix("0x")
    return v


def _config(args):
    from .config import CircuitConfig, load_config

    if getattr(args, "config", None) or os.environ.get("ZKDCAP_CONFIG"):
        return load_config(getattr(args, "config", None))
    return CircuitConfig(degree=18, lookup_bits=17)


def _get_prover(args):
    from .runtime.prover import ECDSAProver

    cfg = _config(args)
    k = args.k if args.k is not None else cfg.degree
    lookup = cfg.lookup_bits if args.k is None else None
    multiopen = getattr(args, "multiopen", None) or cfg.multiopen
    return ECDSAProver(params_dir=args.params_dir, k=k, lookup_bits=lookup,
                       transcript=cfg.transcript, multiopen=multiopen,
                       device=args.device)


def cmd_setup(args):
    if not os.path.isdir(args.params_dir):
        os.makedirs(args.params_dir, exist_ok=True)
    prover = _get_prover(args)
    prover.keygen(force=args.force)
    print(f"wrote artifacts to {args.params_dir}/")


def _input_from_args(args):
    from .circuits.p256_ecdsa import ECDSAInput

    return ECDSAInput.from_hex(
        _read_raw_or_file(args.msghash),
        _read_raw_or_file(args.signature),
        _read_raw_or_file(args.pubkey),
    )


def cmd_prove(args):
    inp = _input_from_args(args)
    assert inp.verify_native(), "input signature does not verify natively"
    prover = _get_prover(args)
    proof = prover.create_proof(inp, evm=args.evm, shards=args.shards,
                                checkpoint=args.checkpoint)
    out = "0x" + proof.hex()
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
        print(f"proof written to {args.output} ({len(proof)} bytes)")
    else:
        print(out)


def cmd_verify(args):
    inp = _input_from_args(args)
    proof = bytes.fromhex(_read_raw_or_file(args.proof))
    prover = _get_prover(args)
    ok = prover.verify(inp.as_instances(), proof, evm=args.evm)
    print("valid" if ok else "INVALID")
    sys.exit(0 if ok else 1)


def cmd_gen_calldata(args):
    from .evm.calldata import encode_calldata

    inp = _input_from_args(args)
    proof = bytes.fromhex(_read_raw_or_file(args.proof))
    data = encode_calldata(inp.as_instances(), proof)
    print("0x" + data.hex())


def cmd_gen_solidity(args):
    # load_vk: emission needs the vk + G2 points only, never the pk arrays
    # or the SRS G1 powers
    prover = _get_prover(args)
    src = prover.gen_evm_verifier()
    if args.output:
        with open(args.output, "w") as f:
            f.write(src)
        print(f"verifier written to {args.output}")
    else:
        print(src)


def cmd_dcap_prove(args):
    from .circuits.dcap import load_demo_input
    from .runtime.dcap_prover import DcapProver

    inp = load_demo_input()
    assert inp.verify_native()
    prover = DcapProver(params_dir=args.params_dir,
                        k=args.k if args.k is not None else 17, device=args.device)
    proof = prover.create_proof(inp, shards=args.shards,
                                checkpoint=args.checkpoint)
    out = "0x" + proof.hex()
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
        print(f"DCAP proof written to {args.output} ({len(proof)} bytes)")
    else:
        print(out)


def cmd_dcap_verify(args):
    from .runtime.dcap_prover import DcapProver

    proof = bytes.fromhex(_read_raw_or_file(args.proof))
    prover = DcapProver(params_dir=args.params_dir,
                        k=args.k if args.k is not None else 17, device=args.device)
    ok = prover.verify(proof)
    print("valid" if ok else "INVALID")
    sys.exit(0 if ok else 1)


def _chain_input(args):
    """--input JSON: {"links": [{"tbs": hex, "r": hex, "s": hex,
    "pubkey_offset": N}, ...], "root_pubkey": [hex, hex]}; default: the
    Intel-leaf demo chain."""
    from .circuits.cert_chain import (
        CertChainInput, CertLink, make_intel_demo_chain)

    if not getattr(args, "input", None):
        return make_intel_demo_chain()
    import json as _json

    with open(args.input) as f:
        d = _json.load(f)
    links = [
        CertLink(tbs=bytes.fromhex(l["tbs"].removeprefix("0x")),
                 r=int(l["r"], 16), s=int(l["s"], 16),
                 pubkey_offset=l["pubkey_offset"])
        for l in d["links"]
    ]
    root = tuple(int(v, 16) for v in d["root_pubkey"])
    return CertChainInput(links=links, root_pubkey=root)


def _quote_input(args):
    """--input JSON with hex report/sig/key fields; default: demo quote."""
    from .circuits.quote import QuoteInput, make_demo_quote

    if not getattr(args, "input", None):
        return make_demo_quote()
    import json as _json

    with open(args.input) as f:
        d = _json.load(f)
    hx = lambda s: bytes.fromhex(s.removeprefix("0x"))
    pair = lambda v: (int(v[0], 16), int(v[1], 16))
    return QuoteInput(
        isv_report=hx(d["isv_report"]), qe3_report=hx(d["qe3_report"]),
        attest_pub=pair(d["attest_pub"]), isv_sig=pair(d["isv_sig"]),
        qe_sig=pair(d["qe_sig"]), pck_pub=pair(d["pck_pub"]),
        mrenclave=hx(d["mrenclave"]), mrsigner=hx(d["mrsigner"]),
        min_cpusvn=hx(d["min_cpusvn"]),
    )


def _roadmap_prove(args, prover, inp, tag):
    assert inp.verify_native(), f"{tag} input does not verify natively"
    proof = prover.create_proof(inp, shards=args.shards,
                                checkpoint=args.checkpoint)
    out = "0x" + proof.hex()
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
        print(f"{tag} proof written to {args.output} ({len(proof)} bytes)")
    else:
        print(out)


def cmd_cert_chain_prove(args):
    from .runtime.chain_provers import CertChainProver

    inp = _chain_input(args)
    prover = CertChainProver(params_dir=args.params_dir, k=args.k,
                             structure=inp, device=args.device)
    _roadmap_prove(args, prover, inp, "cert-chain")


def cmd_cert_chain_verify(args):
    from .runtime.chain_provers import CertChainProver

    proof = bytes.fromhex(_read_raw_or_file(args.proof))
    prover = CertChainProver(params_dir=args.params_dir, k=args.k,
                             structure=_chain_input(args), device=args.device)
    ok = prover.verify(proof)
    print("valid" if ok else "INVALID")
    sys.exit(0 if ok else 1)


def cmd_quote_prove(args):
    from .runtime.chain_provers import QuoteProver

    inp = _quote_input(args)
    prover = QuoteProver(params_dir=args.params_dir, k=args.k, structure=inp,
                         device=args.device)
    _roadmap_prove(args, prover, inp, "quote")


def cmd_quote_verify(args):
    from .runtime.chain_provers import QuoteProver

    proof = bytes.fromhex(_read_raw_or_file(args.proof))
    prover = QuoteProver(params_dir=args.params_dir, k=args.k,
                         structure=_quote_input(args), device=args.device)
    ok = prover.verify(proof)
    print("valid" if ok else "INVALID")
    sys.exit(0 if ok else 1)


def cmd_dcap_mock(args):
    from .chips import CircuitBuilder
    from .circuits.dcap import build_dcap_trace, load_demo_input
    from .plonk.mock import MockProver

    inp = load_demo_input()
    assert inp.verify_native()
    k = args.k if args.k is not None else 17
    trace = build_dcap_trace(inp)
    builder = CircuitBuilder(k, lookup_bits=16)
    compiled = builder.compile(trace)
    advice = builder.witness_columns(compiled, trace)
    MockProver(k, compiled.cs, compiled.fixed_values, advice, [],
               device=args.device).assert_satisfied()
    print(f"DCAP demo circuit satisfied at k={k} "
          f"({len(trace.cells)} cells, {compiled.pinning.num_advice} advice columns)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zk-clique", description=__doc__)
    ap.add_argument("--params-dir", default="params")
    ap.add_argument("--device", default=None,
                    help="torch device of the provers (default: the CUDA card; "
                         "'cpu' runs the plain torch versions of the kernels)")
    ap.add_argument("--k", type=int, default=None,
                    help="circuit degree (overrides --config)")
    ap.add_argument("--shards", type=int, default=None,
                    help="shard the prover across N local cards, --device's "
                         "first (N CPU shards with --device cpu)")
    ap.add_argument("--checkpoint", action="store_true",
                    help="persist per-round proof state under params-dir; "
                         "an interrupted prove resumes on re-run")
    ap.add_argument("--config", default=None,
                    help="JSON circuit config (default: $ZKDCAP_CONFIG, "
                         "reference ECDSA_CONFIG analog)")
    ap.add_argument("--multiopen", choices=("shplonk", "gwc"), default=None,
                    help="final KZG multi-open argument (overrides --config; "
                         "reference ProverGWC/ProverSHPLONK choice)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("setup").add_argument("--force", action="store_true")
    for name in ("prove", "verify", "gen-calldata"):
        p = sub.add_parser(name)
        p.add_argument("--msghash", required=True)
        p.add_argument("--signature", required=True)
        p.add_argument("--pubkey", required=True)
        if name != "prove":
            p.add_argument("--proof", required=True)
        if name == "prove":
            p.add_argument("--evm", action="store_true")
            p.add_argument("--output")
        if name == "verify":
            p.add_argument("--evm", action="store_true")
    p = sub.add_parser("gen-solidity")
    p.add_argument("--output")
    sub.add_parser("dcap-mock")
    p = sub.add_parser("dcap-prove")
    p.add_argument("--output")
    p = sub.add_parser("dcap-verify")
    p.add_argument("--proof", required=True)
    for name in ("cert-chain-prove", "quote-prove"):
        p = sub.add_parser(name)
        p.add_argument("--input", help="JSON input (default: demo data)")
        p.add_argument("--output")
    for name in ("cert-chain-verify", "quote-verify"):
        p = sub.add_parser(name)
        p.add_argument("--input", help="JSON input (default: demo data)")
        p.add_argument("--proof", required=True)

    args = ap.parse_args(argv)
    # guard on missing params dir like the reference (main.rs:256-263)
    if args.cmd != "setup" and not os.path.isdir(args.params_dir):
        print(
            f"`{args.params_dir}` does not exist; run `zk-clique setup` first",
            file=sys.stderr,
        )
        sys.exit(2)
    {
        "setup": cmd_setup,
        "prove": cmd_prove,
        "verify": cmd_verify,
        "gen-calldata": cmd_gen_calldata,
        "gen-solidity": cmd_gen_solidity,
        "dcap-mock": cmd_dcap_mock,
        "dcap-prove": cmd_dcap_prove,
        "dcap-verify": cmd_dcap_verify,
        "cert-chain-prove": cmd_cert_chain_prove,
        "cert-chain-verify": cmd_cert_chain_verify,
        "quote-prove": cmd_quote_prove,
        "quote-verify": cmd_quote_verify,
    }[args.cmd](args)


if __name__ == "__main__":
    main()
