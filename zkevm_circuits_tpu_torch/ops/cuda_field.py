"""Field kernels K1 (Montgomery multiply), K2 (NTT twiddle multiply), K3
(wide REDC), K4 (radix-2 butterfly stage) and field_add_sub (add, subtract
and negate over Fr or Fq), with their plain PyTorch versions.

Each wrapper sends a CUDA tensor to its kernel (csrc/field.cu) and a CPU
tensor to its plain version; there is no other route.  The plain versions
are plain int64 tensor arithmetic, so they also run on CUDA tensors, where
they are the reference the kernels are held against.

Plain arithmetic works on 16 little-endian 16-bit limbs in int64 (the
32-byte rows viewed as int16 pairs).  A digit convolution is an outer
product whose anti-diagonals are summed by `index_add_`; carries are
resolved by split passes and a carry look-ahead built from `cummax`.
Limb products are < 2^32 and column sums < 2^37, far inside int64.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as tnf

from ..crypto.params import FQ_MODULUS, FR_MODULUS
from . import build

M16 = 0xFFFF
NL = 16  # 16-bit limbs per field element
FIELD_FR, FIELD_FQ = 0, 1
MODULI = {FIELD_FR: FR_MODULUS, FIELD_FQ: FQ_MODULUS}
RED_LIMBS = 17  # the NTT's wide REDC divides by 2^272 = 2^(16 * 17)

# kernel launches, counted where each wrapper launches its kernel
LAUNCHES = {"mont_mul": 0, "twiddle_mul": 0, "redc34": 0,
            "butterfly_stage": 0, "fr_add_sub": 0, "fq_add_sub": 0,
            "g1_add": 0, "g1_bucket_add": 0, "g1_double": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain limb arithmetic
# ---------------------------------------------------------------------------
def _limbs_of(x: int, n: int) -> list[int]:
    return [(x >> (16 * i)) & M16 for i in range(n)]


@functools.cache
def _consts(field: int, device: torch.device) -> dict:
    p = MODULI[field]
    npinv = (-pow(p, -1, 1 << 256)) % (1 << 256)
    np272 = (-pow(p, -1, 1 << 272)) % (1 << 272)
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)  # noqa: E731
    return {
        "p": t(_limbs_of(p, NL)),
        "pcomp": t(_limbs_of((1 << 256) - p, NL)),
        "np": t(_limbs_of(npinv, NL)),
        "np272": t(_limbs_of(np272, RED_LIMBS)),
        "pos": {w: torch.arange(w, device=device) for w in (16, 17, 32, 34)},
    }


def to_limbs(a: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 16) int64 16-bit limbs."""
    return a.contiguous().view(torch.int16).to(torch.int64) & M16


def from_limbs(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 canonical limbs -> (..., 32) uint8."""
    y = torch.stack((x & 0xFF, x >> 8), dim=-1)
    return y.reshape(*x.shape[:-1], 2 * x.shape[-1]).to(torch.uint8)


def _shl1(x):
    """Limb i -> limb i + 1, zero fill; the top limb drops out."""
    return tnf.pad(x[..., :-1], (1, 0))


@functools.cache
def _conv_index(na: int, nb: int, device) -> torch.Tensor:
    return (torch.arange(na, device=device)[:, None]
            + torch.arange(nb, device=device)[None, :]).reshape(-1)


def conv(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Digit convolution of (..., na) and (..., nb) limbs: column sums
    c[k] = sum_{i+j=k} a[i] b[j] for k < width.  The (na, nb) outer
    product is added into its anti-diagonal columns with one index_add_
    (integer adds: exact in any order)."""
    na, nb = a.shape[-1], b.shape[-1]
    outer = a[..., :, None] * b[..., None, :]
    lead = outer.shape[:-2]
    out = outer.new_zeros(*lead, na + nb - 1)
    out.index_add_(-1, _conv_index(na, nb, a.device),
                   outer.reshape(*lead, na * nb))
    return out[..., :width]


def canon(x: torch.Tensor, width: int, passes: int, pos=None) -> torch.Tensor:
    """Redundant non-negative limbs -> canonical 16-bit limbs, value mod
    2^(16 * width).  `passes` split passes bring every limb to <= 2^16
    (each pass divides the excess by 2^16); the remaining 0/1 carries are
    resolved at once: the carry out of limb i is the generate bit of the
    last limb <= i that does not propagate (limb != 0xFFFF)."""
    k = x.shape[-1]
    if width > k:
        x = tnf.pad(x, (0, width - k))
    elif width < k:
        x = x[..., :width]
    for _ in range(passes):
        x = (x & M16) + _shl1(x >> 16)
    if pos is None:
        pos = torch.arange(width, device=x.device)
    g = x >> 16
    last = torch.cummax(torch.where(x == M16, -1, pos), dim=-1).values
    cout = torch.gather(g, -1, last.clamp(min=0)) * (last >= 0)
    return (x + _shl1(cout)) & M16


def cond_sub_p(c: torch.Tensor, cs: dict) -> torch.Tensor:
    """Canonical limbs of a value < 2p -> value mod p."""
    s = canon(c + cs["pcomp"], NL + 1, 1, cs["pos"][17])
    return torch.where(s[..., NL:] > 0, s[..., :NL], c)


def add_limbs(a, b, cs):
    return cond_sub_p(canon(a + b, NL + 1, 1, cs["pos"][17])[..., :NL], cs)


def sub_limbs(a, b, cs):
    """a - b + p computed as a + not(b) + 1 + p - 2^256 (the 2^256 wraps
    away in the mod-2^256 canon); the value lies in [1, 2p)."""
    c = a + (M16 - b) + cs["p"]
    c = c + tnf.pad(torch.ones_like(c[..., :1]), (0, NL - 1))
    return cond_sub_p(canon(c, NL, 2, cs["pos"][16]), cs)


def mont_mul_limbs(a, b, cs):
    """Montgomery product of canonical limbs: REDC(a * b) with R = 2^256.
    T = a * b stays in redundant column sums (< 2^36): m = T N' mod 2^256
    needs only T mod 2^256, and its columns stay < 2^56."""
    t = conv(a, b, 2 * NL - 1)
    m = canon(conv(t[..., :NL], cs["np"], NL), NL, 4, cs["pos"][16])
    mp = conv(m, cs["p"], 2 * NL - 1)
    res = canon(tnf.pad(t + mp, (0, 1)), 2 * NL, 3, cs["pos"][32])
    return cond_sub_p(res[..., NL:], cs)


# ---------------------------------------------------------------------------
# K1: Montgomery multiply, Fr or Fq
# ---------------------------------------------------------------------------
def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, field: int) -> torch.Tensor:
    """Plain version of K1: broadcasting (..., 32) u8 Montgomery product."""
    cs = _consts(field, a.device)
    return from_limbs(mont_mul_limbs(to_limbs(a), to_limbs(b), cs))


@functools.cache
def _entry(name: str):
    """The C entry point `name`, looked up once (the first lookup builds and
    loads the library): a call then takes no lock."""
    return getattr(build.lib(), name)


def _stream() -> int:
    """The current device's current stream, as its raw handle (building a
    torch.cuda.Stream object for it costs a few microseconds a call)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def _check_rows(t: torch.Tensor, name: str, dtype=torch.uint8, width=32,
                align=8):
    if t.dtype != dtype or t.shape[-1] != width:
        raise ValueError(f"{name}: expected (..., {width}) {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: expected a contiguous, {align}-byte "
                         f"aligned tensor")


def _operands(a: torch.Tensor, b: torch.Tensor, name: str):
    """K1's and field_add_sub's broadcast rule: (shape, a, b, a_bc, b_bc).
    A single-row operand that the other broadcasts over is passed as its
    one row (a_bc, b_bc), any other broadcast is materialised and a
    non-contiguous operand made contiguous; an operand that already has
    the output's shape and is contiguous is passed as it is."""
    if a.device != b.device:
        raise ValueError(f"{name}: operands on different devices")
    if a.shape == b.shape:
        return a.shape, a.contiguous(), b.contiguous(), False, False
    # one row under a wider operand: the wider one's shape, no broadcast
    # to compute (a row's leading dimensions are all 1)
    if b.numel() == 32 and a.dim() >= b.dim():
        return a.shape, a.contiguous(), b.contiguous(), False, True
    if a.numel() == 32 and b.dim() >= a.dim():
        return b.shape, a.contiguous(), b.contiguous(), True, False
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a_bc = a.numel() == 32 and shape != a.shape
    b_bc = b.numel() == 32 and shape != b.shape
    a = a.contiguous() if a_bc or a.shape == shape else a.expand(shape).contiguous()
    b = b.contiguous() if b_bc or b.shape == shape else b.expand(shape).contiguous()
    return shape, a, b, a_bc, b_bc


def mont_mul_cuda(a: torch.Tensor, b: torch.Tensor, field: int) -> torch.Tensor:
    """K1 on the card: one launch, one new output.  A single-row operand is
    broadcast in the kernel; any other broadcast is materialised first.
    Raises on a CPU operand, a row that is not 16-byte aligned or a failed
    launch."""
    out_shape, a, b, a_bc, b_bc = _operands(a, b, "mont_mul")
    _check_rows(a, "mont_mul a", align=16)
    _check_rows(b, "mont_mul b", align=16)
    out = a.new_empty(out_shape)
    build.check(_entry("zk_mont_mul")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), out.numel() // 32, field,
        a_bc, b_bc, _stream()), "mont_mul")
    LAUNCHES["mont_mul"] += 1
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor, field: int) -> torch.Tensor:
    """K1: CUDA tensors launch the kernel, CPU tensors take the plain version."""
    if a.is_cuda or b.is_cuda:
        return mont_mul_cuda(a, b, field)
    return mont_mul_plain(a, b, field)


# ---------------------------------------------------------------------------
# K2: NTT twiddle multiply (Fr): y[i1, b, j2] * tw[i1, j2]
# ---------------------------------------------------------------------------
def twiddle_mul_plain(y: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: y (n1, nb, n2, 32), tw (n1, n2, 32)."""
    return mont_mul_plain(y, tw[:, None], FIELD_FR)


def twiddle_mul_cuda(y: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    n1, nb, n2, _ = y.shape
    if tw.shape != (n1, n2, 32):
        raise ValueError(f"twiddle_mul: table {tuple(tw.shape)} does not "
                         f"match rows {tuple(y.shape)}")
    y = y.contiguous()
    tw = tw.contiguous()
    _check_rows(y, "twiddle_mul y")
    _check_rows(tw, "twiddle_mul tw")
    out = torch.empty_like(y)
    build.check(_entry("zk_twiddle_mul")(
        y.data_ptr(), tw.data_ptr(), out.data_ptr(), n1 * nb * n2, nb, n2,
        _stream()), "twiddle_mul")
    LAUNCHES["twiddle_mul"] += 1
    return out


def twiddle_mul(y: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """K2: CUDA tensors launch the kernel, CPU tensors take the plain version."""
    if y.is_cuda:
        return twiddle_mul_cuda(y, tw)
    return twiddle_mul_plain(y, tw)


# ---------------------------------------------------------------------------
# K3: wide REDC of the DFT-pass digit sums (Fr)
# ---------------------------------------------------------------------------
def redc34_plain(t32: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: (rows, 63) int32 exact digit sums
    T = sum t[d] 2^(8d) < 2^272 p -> (rows, 32) u8 canonical T * 2^-272 mod p."""
    cs = _consts(FIELD_FR, t32.device)
    t = tnf.pad(t32.to(torch.int64), (0, 1))  # 64 byte digits
    t = t[..., 0::2] + (t[..., 1::2] << 8)  # 32 limbs, each < 2^40
    t = canon(t, 2 * RED_LIMBS, 3, cs["pos"][34])  # T + m p < 2^527
    m = canon(conv(t[..., :RED_LIMBS], cs["np272"], RED_LIMBS), RED_LIMBS, 3,
              cs["pos"][17])
    mp = conv(m, cs["p"], RED_LIMBS + NL - 1)
    res = canon(t + tnf.pad(mp, (0, 2 * RED_LIMBS - mp.shape[-1])),
                2 * RED_LIMBS, 3, cs["pos"][34])
    return from_limbs(cond_sub_p(res[..., RED_LIMBS:RED_LIMBS + NL], cs))


def redc34_cuda(t32: torch.Tensor) -> torch.Tensor:
    t32 = t32.contiguous()
    _check_rows(t32, "redc34 t", dtype=torch.int32, width=63)
    rows = t32.numel() // 63
    out = torch.empty(*t32.shape[:-1], 32, dtype=torch.uint8, device=t32.device)
    build.check(_entry("zk_redc34")(
        t32.data_ptr(), out.data_ptr(), rows, _stream()), "redc34")
    LAUNCHES["redc34"] += 1
    return out


def redc34(t32: torch.Tensor) -> torch.Tensor:
    """K3: CUDA tensors launch the kernel, CPU tensors take the plain version."""
    if t32.is_cuda:
        return redc34_cuda(t32)
    return redc34_plain(t32)


# ---------------------------------------------------------------------------
# K4: radix-2 DIT butterfly stage (Fr): (lo + hi * tw, lo - hi * tw)
# ---------------------------------------------------------------------------
def butterfly_stage_plain(lo: torch.Tensor, hi: torch.Tensor,
                          tw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: broadcasting (..., 32) u8 Montgomery Fr rows."""
    cs = _consts(FIELD_FR, lo.device)
    a = to_limbs(lo)
    t = mont_mul_limbs(to_limbs(hi), to_limbs(tw), cs)
    return from_limbs(add_limbs(a, t, cs)), from_limbs(sub_limbs(a, t, cs))


def butterfly_stage_cuda(lo: torch.Tensor, hi: torch.Tensor,
                         tw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 on the card, the TPU kernel's contract: lo, hi, tw (rows, 32)."""
    if not lo.shape == hi.shape == tw.shape:
        raise ValueError(f"butterfly_stage: shapes {tuple(lo.shape)}, "
                         f"{tuple(hi.shape)}, {tuple(tw.shape)} differ")
    lo, hi, tw = lo.contiguous(), hi.contiguous(), tw.contiguous()
    for t, name in ((lo, "lo"), (hi, "hi"), (tw, "tw")):
        _check_rows(t, f"butterfly_stage {name}")
    out_lo, out_hi = torch.empty_like(lo), torch.empty_like(lo)
    build.check(_entry("zk_butterfly_rows")(
        lo.data_ptr(), hi.data_ptr(), tw.data_ptr(), out_lo.data_ptr(),
        out_hi.data_ptr(), lo.numel() // 32, _stream()), "butterfly_stage")
    LAUNCHES["butterfly_stage"] += 1
    return out_lo, out_hi


def butterfly_stage(lo: torch.Tensor, hi: torch.Tensor,
                    tw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: CUDA tensors launch the kernel, CPU tensors take the plain version."""
    if lo.is_cuda or hi.is_cuda or tw.is_cuda:
        return butterfly_stage_cuda(lo, hi, tw)
    return butterfly_stage_plain(lo, hi, tw)


def _stage_shape(x: torch.Tensor, tw: torch.Tensor, s: int) -> int:
    """log2 of the transform length; raises on a shape the stage cannot take."""
    n = x.shape[-2] if x.dim() >= 2 else 0
    log_n = n.bit_length() - 1
    if n < 2 or n != 1 << log_n or not 1 <= s <= log_n:
        raise ValueError(f"dit_stage: stage {s} of {tuple(x.shape)}")
    if tw.shape != (1 << (s - 1), 32):
        raise ValueError(f"dit_stage: stage {s} needs a ({1 << (s - 1)}, 32) "
                         f"twiddle table, got {tuple(tw.shape)}")
    return log_n


def dit_stage_plain(x: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """Plain version of K4's stage form: stage s (blocks of m = 2^s rows) of
    the DIT ladder over a (..., n, 32) tensor; tw is the stage's
    (m / 2, 32) table."""
    _stage_shape(x, tw, s)
    m, half = 1 << s, 1 << (s - 1)
    xv = x.reshape(*x.shape[:-2], x.shape[-2] // m, m, 32)
    out_lo, out_hi = butterfly_stage_plain(xv[..., :half, :], xv[..., half:, :], tw)
    return torch.cat([out_lo, out_hi], dim=-2).reshape(x.shape)


def dit_stage_cuda(x: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """K4's stage form on the card: one launch over the whole batch."""
    log_n = _stage_shape(x, tw, s)
    x, tw = x.contiguous(), tw.contiguous()
    _check_rows(x, "dit_stage x")
    _check_rows(tw, "dit_stage tw")
    out = torch.empty_like(x)
    build.check(_entry("zk_dit_stage")(
        x.data_ptr(), tw.data_ptr(), out.data_ptr(), x.numel() // 64, log_n, s,
        _stream()), "butterfly_stage")
    LAUNCHES["butterfly_stage"] += 1
    return out


def dit_stage(x: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """K4, stage form: CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    if x.is_cuda or tw.is_cuda:
        return dit_stage_cuda(x, tw, s)
    return dit_stage_plain(x, tw, s)


# ---------------------------------------------------------------------------
# field_add_sub: a + b, a - b or -a over Fr or Fq (crypto/field.py on the
# card); it replaces no Pallas kernel (the JAX package adds in jnp)
# ---------------------------------------------------------------------------
OP_ADD, OP_SUB, OP_NEG = 0, 1, 2  # csrc/bn254.cuh's OP_*
ADD_SUB_COUNTER = {FIELD_FR: "fr_add_sub", FIELD_FQ: "fq_add_sub"}


def _add_sub(a: torch.Tensor, b: torch.Tensor | None, op: int, field: int,
             launch) -> torch.Tensor:
    """Shape logic of field_add_sub around `launch(a, b, out, op, field,
    a_bc, b_bc)`, K1's broadcast rule (_operands).  Neg reads `a` only (b
    is None).  One output, a new tensor."""
    if op == OP_NEG:
        shape, a, a_bc, b_bc = a.shape, a.contiguous(), False, False
    else:
        shape, a, b, a_bc, b_bc = _operands(a, b, "field_add_sub")
    out = a.new_empty(shape)
    launch(a, b, out, op, field, a_bc, b_bc)
    return out


def _add_sub_plain_launch(a, b, out, op, field, a_bc, b_bc):
    """The limb code into `out`; a broadcast row broadcasts as a tensor."""
    cs = _consts(field, a.device)
    x = to_limbs(a)
    if op == OP_NEG:
        r = sub_limbs(torch.zeros_like(x), x, cs)
    else:
        r = (add_limbs if op == OP_ADD else sub_limbs)(x, to_limbs(b), cs)
    out.copy_(from_limbs(r))


def _add_sub_cuda_launch(a, b, out, op, field, a_bc, b_bc):
    _check_rows(a, "field_add_sub a", align=16)
    if b is not None:
        _check_rows(b, "field_add_sub b", align=16)
    build.check(_entry("zk_field_add_sub")(
        a.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
        out.numel() // 32, field, op, a_bc, b_bc, _stream()),
        "field_add_sub")
    LAUNCHES[ADD_SUB_COUNTER[field]] += 1


def field_add_sub_cuda(a: torch.Tensor, b: torch.Tensor | None, op: int,
                       field: int) -> torch.Tensor:
    """a + b (OP_ADD), a - b (OP_SUB) or -a (OP_NEG, b None) of canonical
    (..., 32) CUDA rows over `field`, broadcasting: one launch of
    field_add_sub, counted as "fr_add_sub" or "fq_add_sub"; raises on a
    CPU operand, a row that is not 16-byte aligned or a failed launch."""
    return _add_sub(a, b, op, field, _add_sub_cuda_launch)


def field_add_sub_plain(a: torch.Tensor, b: torch.Tensor | None, op: int,
                        field: int) -> torch.Tensor:
    """Plain version of field_add_sub: the 16-bit-limb add_limbs and
    sub_limbs under the same broadcast rule."""
    return _add_sub(a, b, op, field, _add_sub_plain_launch)
