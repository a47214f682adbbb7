"""PLONKish prover: keygen'd pk + witness -> SHPLONK proof bytes.

Port of ``zkdcap_tpu/plonk/prover.py`` (halo2 ``create_proof``):

  1. advice columns, blinded                 -- batched INTT + MSM
  2. lookup permuted columns                 -- compress, device permute, MSM
  3. permutation grand products              -- batch inverse, prefix product, MSM
  4. lookup grand products                   -- same
  5. vanishing random poly                   -- MSM
  6. quotient h(X) on the extended coset     -- gate/permutation/lookup terms
  7. evaluations at x                        -- power-table sums
  8. SHPLONK multiopen                       -- poly division + 2 MSMs
     (or GWC: one witness quotient and one MSM per distinct point)

The transcript runs on the host between rounds. With ``checkpoint_dir``,
rounds 1-6 save their state (``plonk/checkpoint.py``) and a re-invoked
proof resumes after the last saved round. Blinding comes from a
caller-seeded PRNG when a seed is given (byte-identical proofs), else from
fresh entropy. Every Montgomery product runs kernel E on the card. With a
mesh (``parallel/``) the commitments are sharded MSMs and rounds 3, 4 and 6
run per row block (``plonk/row_sharder.py``); the bytes do not change.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import torch

from ..commit.gwc import gwc_open
from ..commit.kzg import ParamsKZG
from ..commit.shplonk import ProverQuery, shplonk_open
from ..device import resolve
from ..fields import mont
from ..fields.params import BN254_FR
from ..ntt import intt, intt_many
from ..parallel.mesh import _is_mesh
from ..poly.ops import batched_sum, power_table_for, power_table_row
from ..transcript import TranscriptWriter
from .checkpoint import Preempted, ProofCheckpoint
from .cs import ConstraintSystem
from .expression import Evaluator
from .keygen import DELTA, ProvingKey, collect_queries
from .row_sharder import RowSharder

R = BN254_FR.p
F = BN254_FR

# Wall seconds of each round of the last create_proof, by the reference's
# phase names (its metrics.record analog).
last_phases: dict[str, float] = {}


def _seeded_rand_ints(seed: bytes, count: int) -> list[int]:
    out = []
    ctr = 0
    while len(out) < count:
        h = hashlib.blake2b(seed + ctr.to_bytes(8, "little"), digest_size=64).digest()
        out.append(int.from_bytes(h, "little") % R)
        ctr += 1
    return out


def _enc(values, device) -> torch.Tensor:
    return mont.encode_ints(F, [v % R for v in values], device=device)


def _sort_keys(rows: torch.Tensor) -> torch.Tensor:
    """(m, 16) canonical 16-bit limbs -> (m, 4) int64 keys whose
    lexicographic order is the memcmp order of the little-endian limb bytes:
    per-u16 byte swap, limbs 2j and 2j+1 as one u32 key, and two u32 keys
    per int64 with the sign bit flipped so that signed order is unsigned
    order."""
    c = rows.to(torch.int64)
    sw = ((c & 0xFF) << 8) | (c >> 8)
    k32 = (sw[:, 0::2] << 16) | sw[:, 1::2]  # (m, 8) u32 keys, most significant first
    return (k32[:, 0::2] - (1 << 31)) * (1 << 32) + k32[:, 1::2]


def lookup_permute(a_std: torch.Tensor, s_std: torch.Tensor, u: int):
    """The device multiset permute of one lookup, equal to the reference's
    ``_permute_lookup_pair_rows`` row for row (its order reaches the proof
    bytes): one stable sort of [A rows | S rows] in memcmp order, then
    cumsums and scatters. Returns (a_order, s_pos), int64 indices into
    the first u rows; raises ValueError when an input value is missing from
    the table."""
    dev = a_std.device
    c = torch.cat([a_std[:u], s_std[:u]])
    m = 2 * u
    keys = _sort_keys(c)
    pay = torch.arange(m, device=dev)
    for j in range(keys.shape[1] - 1, -1, -1):  # LSD: stable passes, least key first
        pay = pay[torch.sort(keys[pay, j], stable=True).indices]
    K = keys[pay]
    pos = torch.arange(m, device=dev)
    newgrp = torch.ones(m, dtype=torch.bool, device=dev)
    newgrp[1:] = (K[1:] != K[:-1]).any(1)
    start_pos = torch.cummax(torch.where(newgrp, pos, -1), 0).values
    is_a = pay < u
    ia = is_a.to(torch.int64)
    ex_a = torch.cumsum(ia, 0) - ia  # A rows before this row
    a_rank = ex_a - ex_a[start_pos]  # rank among the A rows of the group
    # first S row of each group (the stable sort puts A before S within a
    # value group, so the tag flips at most once per group)
    prev_a = torch.zeros_like(is_a)
    prev_a[1:] = is_a[:-1]
    is_first_s = ~is_a & (newgrp | prev_a)
    gid = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    grp_first_s = torch.full((m + 1,), -1, dtype=torch.int64, device=dev)
    grp_first_s[torch.where(is_first_s, gid, m)] = pos
    match = grp_first_s[gid]
    if bool((is_a & (match < 0)).any()):
        raise ValueError("lookup failure: input value not in table")
    a_first = is_a & (a_rank == 0)
    match_s = pay[match.clamp(min=0)] - u
    # unused S rows (fillers), paired k-th <-> k-th with the non-first A rows
    filler = ~is_a & ~(is_first_s & is_a[start_pos])
    needy = is_a & (a_rank > 0)
    fi, ni = filler.to(torch.int64), needy.to(torch.int64)
    filler_pay = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    filler_pay[torch.where(filler, torch.cumsum(fi, 0) - fi, m)] = pay - u
    s_val = torch.where(a_first, match_s, filler_pay[torch.cumsum(ni, 0) - ni])
    # compact to A'-row order (rank r = ex_a for A rows)
    dest = torch.where(is_a, ex_a, m)
    a_order = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    s_pos = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    a_order[dest] = pay
    s_pos[dest] = s_val
    return a_order[:u], s_pos[:u]


def _lookup_compress(cs: ConstraintSystem, ev: Evaluator, theta_r: torch.Tensor):
    """Each lookup's theta-combined input and table columns (Montgomery)."""
    out = []
    for lk in cs.lookups:
        theta_pow = mont.one_mont(F, (1,), theta_r.device)
        a_comp = s_comp = None
        for e_in, e_tb in zip(lk.inputs, lk.tables):
            a_term = mont.mont_mul(F, ev.eval(e_in), theta_pow)
            s_term = mont.mont_mul(F, ev.eval(e_tb), theta_pow)
            a_comp = a_term if a_comp is None else mont.add(F, a_comp, a_term)
            s_comp = s_term if s_comp is None else mont.add(F, s_comp, s_term)
            theta_pow = mont.mont_mul(F, theta_pow, theta_r)
        out.append((a_comp, s_comp))
    return out


def _perm_z(pk: ProvingKey, advice_lagr, instance_lagr, beta_r, gamma_r, blinds, mesh=None):
    """Round 3: every chunk's grand product, chained across chunks and
    blinded, in Lagrange form; with `mesh`, num and den per row block."""
    cs = pk.cs
    n = 1 << pk.k
    u = cs.usable_rows(n)
    m = len(cs.permutation_columns)
    chunk = cs.permutation_chunk_len
    rows = RowSharder(mesh, n, beta_r.device)
    omega_pows = power_table_for(F, pk.domain.omega, n, beta_r.device)
    rows.split_pk(pk, "fixed_lagrange", pk.fixed_lagrange)
    rows.split_pk(pk, "sigma_lagrange", pk.sigma_lagrange)
    rows.split(omega_pows, *advice_lagr, *instance_lagr)
    cols = {"fixed": pk.fixed_lagrange, "advice": advice_lagr, "instance": instance_lagr}
    blocks = range(len(rows.devices))
    betas = [beta_r.to(dev) for dev in rows.devices]
    gammas = [gamma_r.to(dev) for dev in rows.devices]
    zs, last_z_end = [], None
    for zi, c0 in enumerate(range(0, m, chunk)):
        def num_den(b, beta_b, gamma_b):
            dev = beta_b.device
            num = den = None
            for i in range(c0, min(c0 + chunk, m)):
                col = cs.permutation_columns[i]
                vals = rows.block(cols[col.kind][col.index], b)
                bd = mont.mont_mul(F, beta_b, _enc([pow(DELTA, i, R)], dev))
                nterm = mont.add(F, mont.add(F, vals, mont.mont_mul(F, rows.block(omega_pows, b),
                                                                    bd)), gamma_b)
                sterm = mont.mont_mul(F, rows.block(pk.sigma_lagrange[i], b), beta_b)
                dterm = mont.add(F, mont.add(F, vals, sterm), gamma_b)
                num = nterm if num is None else mont.mont_mul(F, num, nterm)
                den = dterm if den is None else mont.mont_mul(F, den, dterm)
            return num, den

        nums, dens = zip(*rows.map(num_den, blocks, betas, gammas))
        z = rows.grand_product(nums, dens, u, carry=last_z_end)
        last_z_end = z[u : u + 1].clone()
        z[u + 1 :] = blinds[zi]
        zs.append(z)
    return zs


def _lookup_z(pk: ProvingKey, lookup_data, beta_r, gamma_r, blinds, mesh=None):
    """Round 4: each lookup's grand product, blinded, in Lagrange form; with
    `mesh`, num and den per row block."""
    n = 1 << pk.k
    u = pk.cs.usable_rows(n)
    rows = RowSharder(mesh, n, beta_r.device)
    blocks = range(len(rows.devices))
    betas = [beta_r.to(dev) for dev in rows.devices]
    gammas = [gamma_r.to(dev) for dev in rows.devices]
    zs = []
    for ld, blind in zip(lookup_data, blinds):
        arrs = [ld[key] for key in ("a", "s", "a_perm", "s_perm")]
        rows.split(*arrs)

        def num_den(b, beta_b, gamma_b):
            a, s_, ap, sp = (rows.block(x, b) for x in arrs)
            return (mont.mont_mul(F, mont.add(F, a, beta_b), mont.add(F, s_, gamma_b)),
                    mont.mont_mul(F, mont.add(F, ap, beta_b), mont.add(F, sp, gamma_b)))

        nums, dens = zip(*rows.map(num_den, blocks, betas, gammas))
        z = rows.grand_product(nums, dens, u)
        z[u + 1 :] = blind
        zs.append(z)
    return zs


def opening_plan(cs: ConstraintSystem, n: int):
    """Every opening of the proof, as (label, rotation) in the multiopen's
    query order: the single source of the round-7 evaluation plan, the
    order the evaluations are written, and the SHPLONK query list. The
    rotation of the chunk-chaining opening of a permutation z is u."""
    u = cs.usable_rows(n)
    m = len(cs.permutation_columns)
    n_z = -(-m // cs.permutation_chunk_len) if m else 0
    adv_q, fix_q, _ = collect_queries(cs)
    plan = [(f"advice{ci}", rot) for ci, rot in adv_q]
    plan += [(f"fixed{ci}", rot) for ci, rot in fix_q]
    plan.append(("random", 0))
    plan += [(f"sigma{i}", 0) for i in range(m)]
    # the verifier derives h's value itself, but the multiopen opens it
    plan.append(("h", 0))
    for c in range(n_z):
        plan += [(f"permz{c}", 0), (f"permz{c}", 1)]
        if c + 1 < n_z:
            plan.append((f"permz{c}", u))
    for li in range(len(cs.lookups)):
        plan += [(f"lkz{li}", 0), (f"lkz{li}", 1), (f"lkA{li}", 0), (f"lkA{li}", -1),
                 (f"lkS{li}", 0)]
    return plan


def evals_query_plan(cs: ConstraintSystem, n: int):
    """The distinct openings grouped by rotation: (rot -> [labels], sorted
    rotations), as the reference's ``_evals_query_plan``."""
    groups: dict[int, list[str]] = {}
    for label, rot in dict.fromkeys(opening_plan(cs, n)):
        groups.setdefault(rot, []).append(label)
    return groups, sorted(groups)


def _evaluations(pk: ProvingKey, arrs: dict, h_pieces, x_row: torch.Tensor):
    """Round 7: h = sum_i x^(n i) h_i and every opening value sum_i c_i (x
    w^rot)^i, as (x w^rot)^i = x^i (w^rot)^i. Returns (h, {(label, rot):
    value})."""
    domain = pk.domain
    n = domain.n
    xpow = power_table_row(F, x_row, n + 1)  # x^0 .. x^n
    xn_row = xpow[n : n + 1]
    h = h_pieces[0]
    xni = xn_row
    for piece in h_pieces[1:]:
        h = mont.add(F, h, mont.mont_mul(F, piece, xni))
        xni = mont.mont_mul(F, xni, xn_row)
    arrs = dict(arrs, h=h)
    groups, rots = evals_query_plan(pk.cs, n)
    values = {}
    for rot in rots:
        pows = xpow[:n]
        if rot:
            w_rot = pow(domain.omega, rot, R) if rot > 0 else pow(domain.omega_inv, -rot, R)
            pows = mont.mont_mul(F, pows, power_table_for(F, w_rot, n, x_row.device))
        stacked = torch.stack([arrs[lb] for lb in groups[rot]], 1)
        sums = batched_sum(F, mont.mont_mul(F, stacked, pows[:, None]))
        for label, v in zip(groups[rot], mont.decode_ints(F, sums)):
            values[(label, rot)] = v
    return h, values


def create_proof(
    params: ParamsKZG,
    pk: ProvingKey,
    advice_values: list[torch.Tensor],
    instances: list[list[int]],
    transcript: TranscriptWriter,
    blinding_seed: bytes | None = None,
    timing: bool = False,
    mesh=None,
    checkpoint_dir: str | None = None,
    multiopen: str = "shplonk",
    _abort_after: str | None = None,
    device=None,
) -> bytes:
    """The prover rounds; returns the proof bytes. `advice_values` are the
    advice columns as int32[n, 16] Montgomery arrays. `timing=True` prints
    each round's wall time to stderr (every round ends on a host read).

    blinding_seed=None draws fresh entropy per proof (hiding commitments);
    pass a seed only for reproducible proofs.

    multiopen: "shplonk" (BDFG20, the reference's pick) or "gwc" (GWC19).

    checkpoint_dir: after each commit round r1..r6 the transcript op log and
    the round's arrays persist to <dir>/ck_<transcript kind>_rN.npz, in the
    JAX package's format; a re-invoked create_proof with the same inputs
    resumes after the last completed round and emits a byte-identical
    proof. Checkpoints are removed on success. `_abort_after` is a
    test-only hook simulating preemption after a named round (r1..r6).

    mesh: a ``parallel.Mesh`` whose first shard is the pk's device. Every
    commitment is a sharded MSM, and rounds 3, 4 and 6 run per row block
    (``plonk/row_sharder.py``) unless ``ZKDCAP_SHARD_ROWS=0`` (read at each
    call). The proof bytes equal the single-device proof's."""
    if multiopen not in ("shplonk", "gwc"):
        raise ValueError(f"unknown multiopen {multiopen!r}")
    dev = resolve(device)
    rows_mesh = None
    if mesh is not None:
        mesh = _is_mesh(mesh)
        if mesh.first != pk.device:
            raise ValueError(f"the mesh's first shard {mesh.first} is not the pk's device "
                             f"{pk.device}")
        if os.environ.get("ZKDCAP_SHARD_ROWS", "1") != "0":
            rows_mesh = mesh
    if blinding_seed is None:
        blinding_seed = os.urandom(32)
    last_phases.clear()
    clock = [time.perf_counter()]

    def _phase(name):
        now = time.perf_counter()
        last_phases[name] = now - clock[0]
        if timing:
            print(f"[prover] {name}: {now - clock[0]:.2f}s", file=sys.stderr, flush=True)
        clock[0] = now

    def _blind_vals(tag: bytes, count: int) -> torch.Tensor:
        return _enc(_seeded_rand_ints(blinding_seed + tag, count), dev)

    def _row(v: int) -> torch.Tensor:
        return _enc([v], dev)

    cs = pk.cs
    n = 1 << pk.k
    u = cs.usable_rows(n)
    domain = pk.domain

    # per-transcript-round checkpoints; no-op when checkpoint_dir is None
    ck = None
    ck_fp = ""
    if checkpoint_dir is not None:
        ck_fp = hashlib.blake2b(
            repr((pk.vk.k, transcript.kind, pk.vk.transcript_repr(),
                  [list(c) for c in instances])).encode(),
            digest_size=16,
        ).hexdigest()
        ck = ProofCheckpoint(checkpoint_dir, tag=transcript.kind)

    def _resume(round_name):
        """The saved state of a round, or None when it must run."""
        if ck and ck.has(round_name):
            return ck.load(round_name, transcript, ck_fp, device=dev)
        return None

    def _done(round_name, **state):
        if ck:
            ck.save(round_name, transcript, ck_fp, **state)

    def _abort(round_name):
        if _abort_after == round_name:
            raise Preempted(f"aborted after {round_name} (test hook)")

    # --- round 0: bind vk + public inputs --------------------------------
    transcript.common_scalar(pk.vk.transcript_repr())
    instances = [list(col) for col in instances]
    if len(instances) != cs.num_instance:
        raise ValueError(f"{len(instances)} instance columns for {cs.num_instance}")
    for col in instances:
        for v in col:
            transcript.common_scalar(v)
    instance_lagrange = [_enc(col + [0] * (n - len(col)), dev) for col in instances]

    # --- round 1: advice commitments -------------------------------------
    if len(advice_values) != cs.num_advice:
        raise ValueError(f"{len(advice_values)} advice columns for {cs.num_advice}")
    st = _resume("r1")
    if st is not None:
        blinding_seed = st["seed"]  # later rounds' blinding must match
        advice_lagrange, advice_coeff = st["advice_lagrange"], st["advice_coeff"]
    else:
        advice_lagrange = []
        for i, a in enumerate(advice_values):
            a = a.to(dev).clone()
            a[u + 1 :] = _blind_vals(b"adv%d" % i, n - u - 1)
            advice_lagrange.append(a)
        advice_coeff = intt_many(F, advice_lagrange)
        for pt in params.commit_many(advice_coeff, mesh=mesh):
            transcript.write_point(pt)
        _done("r1", seed=blinding_seed, advice_lagrange=advice_lagrange,
              advice_coeff=advice_coeff)
    _abort("r1")
    _phase("advice commit")
    theta = transcript.squeeze_challenge()

    # --- round 2: lookup permuted columns --------------------------------
    st = _resume("r2")
    if st is not None:
        lookup_data = st["lookup_data"]
    else:
        lookup_data = []
        if cs.lookups:
            ev = Evaluator(pk.fixed_lagrange, advice_lagrange, instance_lagrange,
                           challenges={"theta": theta})
            perm_lagr = []
            for li, (a_comp, s_comp) in enumerate(_lookup_compress(cs, ev, _row(theta))):
                a_order, s_pos = lookup_permute(mont.from_mont(F, a_comp),
                                                mont.from_mont(F, s_comp), u)
                a_perm = torch.cat([a_comp[:u][a_order], _blind_vals(b"lkA%d" % li, n - u)])
                s_perm = torch.cat([s_comp[:u][s_pos], _blind_vals(b"lkS%d" % li, n - u)])
                lookup_data.append({"a": a_comp, "s": s_comp, "a_perm": a_perm,
                                    "s_perm": s_perm})
                perm_lagr += [a_perm, s_perm]
            perm_coeffs = intt_many(F, perm_lagr)
            for li, ld in enumerate(lookup_data):
                ld["a_perm_coeff"] = perm_coeffs[2 * li]
                ld["s_perm_coeff"] = perm_coeffs[2 * li + 1]
            for pt in params.commit_many(perm_coeffs, mesh=mesh):
                transcript.write_point(pt)
        _done("r2", lookup_data=lookup_data)
    _abort("r2")
    _phase("lookup permute+commit")
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()
    beta_r, gamma_r = _row(beta), _row(gamma)

    # --- round 3: permutation grand products -----------------------------
    m = len(cs.permutation_columns)
    st = _resume("r3")
    if st is not None:
        perm_z_coeff = st["perm_z_coeff"]
    else:
        perm_z_coeff = []
        if m:
            blinds = [_blind_vals(b"permz%d" % zi, n - u - 1)
                      for zi in range(-(-m // cs.permutation_chunk_len))]
            perm_z_coeff = intt_many(F, _perm_z(pk, advice_lagrange, instance_lagrange,
                                                beta_r, gamma_r, blinds, mesh=rows_mesh))
        for pt in params.commit_many(perm_z_coeff, mesh=mesh):
            transcript.write_point(pt)
        _done("r3", perm_z_coeff=perm_z_coeff)
    _abort("r3")
    _phase("permutation z")

    # --- round 4: lookup grand products ----------------------------------
    st = _resume("r4")
    if st is not None:
        z_coeffs = st["z_coeffs"]
    elif lookup_data:
        blinds = [_blind_vals(b"lkz%d" % li, n - u - 1) for li in range(len(lookup_data))]
        z_coeffs = intt_many(F, _lookup_z(pk, lookup_data, beta_r, gamma_r, blinds,
                                          mesh=rows_mesh))
        for pt in params.commit_many(z_coeffs, mesh=mesh):
            transcript.write_point(pt)
    else:
        z_coeffs = []
    for ld, zc in zip(lookup_data, z_coeffs):
        ld["z_coeff"] = zc
        for key in ("a", "s", "a_perm", "s_perm"):
            ld.pop(key, None)  # the quotient reads the coefficient forms only
    if st is None:
        _done("r4", z_coeffs=z_coeffs)
    _abort("r4")
    _phase("lookup z")

    # --- round 5: vanishing random poly ----------------------------------
    random_poly = _enc(_seeded_rand_ints(blinding_seed + b"rand", n), dev)
    # the poly is seed-determined: a resume restores only the transcript
    if _resume("r5") is None:
        transcript.write_point(params.commit(random_poly, mesh=mesh))
        _done("r5")
    _abort("r5")
    y = transcript.squeeze_challenge()

    # --- round 6: quotient ------------------------------------------------
    st = _resume("r6")
    if st is not None:
        h_pieces = st["h_pieces"]
    else:
        h_pieces = _compute_quotient(pk, advice_coeff, instance_lagrange, lookup_data,
                                     perm_z_coeff, _row(theta), beta_r, gamma_r, _row(y),
                                     mesh=rows_mesh)
        for pt in params.commit_many(h_pieces, mesh=mesh):
            transcript.write_point(pt)
        _done("r6", h_pieces=h_pieces)
    _abort("r6")
    _phase("quotient")
    x = transcript.squeeze_challenge()

    # --- round 7: evaluations --------------------------------------------
    polys = {"random": random_poly}
    polys.update((f"advice{i}", c) for i, c in enumerate(advice_coeff))
    polys.update((f"fixed{i}", c) for i, c in enumerate(pk.fixed_coeff))
    polys.update((f"sigma{i}", c) for i, c in enumerate(pk.sigma_coeff))
    polys.update((f"permz{c}", zc) for c, zc in enumerate(perm_z_coeff))
    for li, ld in enumerate(lookup_data):
        polys.update({f"lkz{li}": ld["z_coeff"], f"lkA{li}": ld["a_perm_coeff"],
                      f"lkS{li}": ld["s_perm_coeff"]})
    polys["h"], values = _evaluations(pk, polys, h_pieces, _row(x)[0])

    def point_at(rot: int) -> int:
        w = pow(domain.omega, rot, R) if rot >= 0 else pow(domain.omega_inv, -rot, R)
        return x * w % R

    queries, eval_cache = [], {}
    for label, rot in opening_plan(cs, n):
        pt = point_at(rot)
        queries.append(ProverQuery(label, polys[label], pt))
        if (label, pt) in eval_cache:
            continue
        eval_cache[(label, pt)] = values[(label, rot)]
        if label != "h":  # the verifier derives h(x) itself
            transcript.write_scalar(values[(label, rot)])
    _phase("evals")

    # --- round 8: multiopen ----------------------------------------------
    opener = gwc_open if multiopen == "gwc" else shplonk_open
    opener(params, transcript, queries, mesh=mesh, evals=eval_cache)
    _phase("multiopen")
    if ck:
        ck.clear()  # consumed: a finished proof leaves no resume state
    return transcript.finalize()


def _compute_quotient(pk: ProvingKey, advice_coeff, instance_lagrange, lookup_data,
                      perm_z_coeff, theta_r, beta_r, gamma_r, y_r, mesh=None):
    """Round 6: sum_i y^i * constraint_i on the extended coset, divided by
    Z_H; returns the quotient pieces in coefficient form (n each). The
    extended arrays are made whole on the first shard; with `mesh`, each
    shard evaluates the constraints on its row block."""
    cs = pk.cs
    domain = pk.domain
    n = domain.n
    ext_n = domain.extended_n
    dev = y_r.device

    advice_ext = [domain.coeff_to_extended(a) for a in advice_coeff]
    instance_ext = [domain.coeff_to_extended(intt(F, i)) for i in instance_lagrange]
    zs_ext = [domain.coeff_to_extended(zc) for zc in perm_z_coeff]
    lookups_ext = [tuple(domain.coeff_to_extended(ld[key])
                         for key in ("z_coeff", "a_perm_coeff", "s_perm_coeff"))
                   for ld in lookup_data]
    xs = None
    if cs.permutation_columns:
        xs = mont.mont_mul(F, power_table_for(F, domain.extended_omega, ext_n, dev),
                           _enc([domain.g_coset], dev))
    rows = RowSharder(mesh, ext_n, dev)
    for tag in ("fixed_extended", "sigma_extended"):
        rows.split_pk(pk, tag, getattr(pk, tag))
    rows.split_pk(pk, "selectors_extended", (pk.l0_ext, pk.llast_ext, pk.lblind_ext, pk.zh_inv_ext))
    rows.split(*advice_ext, *instance_ext, *zs_ext, *(a for t in lookups_ext for a in t),
               *(() if xs is None else (xs,)))
    challenges = [[r.to(dev) for dev in rows.devices] for r in (theta_r, beta_r, gamma_r, y_r)]
    h_ext = rows.gather(rows.map(
        lambda b, *ch: _quotient_block(pk, rows, b, advice_ext, instance_ext, zs_ext,
                                       lookups_ext, xs, *ch),
        range(len(rows.devices)), *challenges))
    h_coeff = domain.extended_to_coeff(h_ext)
    return [h_coeff[i * n : (i + 1) * n] for i in range(cs.quotient_pieces())]


def _quotient_block(pk: ProvingKey, rows: RowSharder, b: int, advice_ext, instance_ext, zs_ext,
                    lookups_ext, xs, theta_r, beta_r, gamma_r, y_r):
    """Block b of (sum_i y^i * constraint_i) / Z_H, on its shard."""
    cs = pk.cs
    n = pk.domain.n
    ratio = pk.domain.extended_n // n
    u = cs.usable_rows(n)
    m = len(cs.permutation_columns)
    chunk = cs.permutation_chunk_len
    dev = y_r.device
    l0, llast = rows.block(pk.l0_ext, b), rows.block(pk.llast_ext, b)

    def at(x, shift=0):  # block b of x(w^(shift / ratio) X)
        return rows.block(x, b, shift)

    ev = Evaluator(pk.fixed_extended, advice_ext, instance_ext, rot_scale=ratio,
                   challenges={"theta": theta_r}, rows=rows, block=b)
    one_ext = mont.one_mont(F, (1,), dev)
    active = mont.sub(F, one_ext, mont.add(F, llast, at(pk.lblind_ext)))

    acc = None
    y_pow = mont.one_mont(F, (1,), dev)

    def add_constraint(vals):
        nonlocal acc, y_pow
        term = mont.mont_mul(F, vals, y_pow)
        acc = term if acc is None else mont.add(F, acc, term)
        y_pow = mont.mont_mul(F, y_pow, y_r)

    def boundary(z):  # l_0 (1 - z) and l_last (z^2 - z)
        add_constraint(mont.mont_mul(F, l0, mont.sub(F, one_ext, z)))
        add_constraint(mont.mont_mul(F, llast, mont.sub(F, mont.mont_mul(F, z, z), z)))

    # gates
    for g in cs.gates:
        for poly in g.polys:
            add_constraint(ev.eval(poly))

    # permutation
    if m:
        add_constraint(mont.mont_mul(F, l0, mont.sub(F, one_ext, at(zs_ext[0]))))
        zl = at(zs_ext[-1])
        add_constraint(mont.mont_mul(F, llast, mont.sub(F, mont.mont_mul(F, zl, zl), zl)))
        # chunk chaining: l_0 (z_c - z_{c-1}(w^u X))
        for c in range(1, len(zs_ext)):
            prev_rot = at(zs_ext[c - 1], u * ratio)
            add_constraint(mont.mont_mul(F, l0, mont.sub(F, at(zs_ext[c]), prev_rot)))
        # active (z(wX) prod(col + beta sigma + gamma) - z prod(col + beta delta^i X + gamma))
        cols = {"fixed": pk.fixed_extended, "advice": advice_ext, "instance": instance_ext}
        xs_b = at(xs)
        for ci, c0 in enumerate(range(0, m, chunk)):
            left = at(zs_ext[ci], ratio)
            right = at(zs_ext[ci])
            for i in range(c0, min(c0 + chunk, m)):
                col = cs.permutation_columns[i]
                vals = at(cols[col.kind][col.index])
                sterm = mont.mont_mul(F, at(pk.sigma_extended[i]), beta_r)
                left = mont.mont_mul(F, left, mont.add(F, mont.add(F, vals, sterm), gamma_r))
                bd = mont.mont_mul(F, beta_r, _enc([pow(DELTA, i, R)], dev))
                idterm = mont.mont_mul(F, xs_b, bd)
                right = mont.mont_mul(F, right, mont.add(F, mont.add(F, vals, idterm), gamma_r))
            add_constraint(mont.mont_mul(F, active, mont.sub(F, left, right)))

    # lookups
    for (a_comp, s_comp), (z_ext, ap_ext, sp_ext) in zip(_lookup_compress(cs, ev, theta_r),
                                                         lookups_ext):
        z_b, ap_b, sp_b = at(z_ext), at(ap_ext), at(sp_ext)
        z_next = at(z_ext, ratio)
        ap_prev = at(ap_ext, -ratio)
        boundary(z_b)
        # active (z(wX)(A' + beta)(S' + gamma) - z(X)(A + beta)(S + gamma))
        lhs = mont.mont_mul(F, z_next, mont.mont_mul(F, mont.add(F, ap_b, beta_r),
                                                     mont.add(F, sp_b, gamma_r)))
        rhs = mont.mont_mul(F, z_b, mont.mont_mul(F, mont.add(F, a_comp, beta_r),
                                                  mont.add(F, s_comp, gamma_r)))
        add_constraint(mont.mont_mul(F, active, mont.sub(F, lhs, rhs)))
        ap_sp = mont.sub(F, ap_b, sp_b)
        add_constraint(mont.mont_mul(F, l0, ap_sp))  # l_0 (A' - S')
        # active (A' - S') (A' - A'(w^-1 X))
        add_constraint(mont.mont_mul(F, active, mont.mont_mul(F, ap_sp, mont.sub(F, ap_b, ap_prev))))

    return mont.mont_mul(F, acc, at(pk.zh_inv_ext))
