"""Batched ed25519 signature verification on the device.

Port of the host half of plenum_tpu/ops/ed25519_jax.py (`host_pack`, the
limb and canonicality helpers, `verify_batch_async`) and of the Pallas
kernel plenum_tpu/ops/ed25519_pallas.py (now csrc/ed25519_verify.cu, four
CUDA lanes per signature), with the JAX package's mesh split of a batch
(`launch_lanes`, ops/mesh.py).

The host does the cheap data-dependent work: canonicality checks (y < p,
s < L), k = SHA-512(R||A||M) mod L, and packing into 20 radix-2^13 limbs
per y coordinate and 8 little-endian u32 words per scalar. The device does
the elliptic-curve work: `verify` launches the CUDA kernel on CUDA tensors
and runs `verify_plain`, the same cofactorless equation in int64 PyTorch
field arithmetic, on CPU tensors. Verification is [S]B + [k](-A) compared
projectively with the decompressed R.
"""
from __future__ import annotations

import ctypes
import hashlib
from typing import List, Sequence

import numpy as np
import torch

from plenum_tpu_torch.ops import check_arg, cuda_lib, resolve_device, to_tensor

# ---------------------------------------------------------------- constants

NLIMB = 20
RADIX = 13
MASK = (1 << RADIX) - 1

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D_INT = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1_INT = pow(2, (P - 1) // 4, P)
G_Y_INT = (4 * pow(5, P - 2, P)) % P


def _int_to_limbs(v: int) -> np.ndarray:
    out = np.zeros(NLIMB, dtype=np.int64)
    for i in range(NLIMB):
        out[i] = v & MASK
        v >>= RADIX
    if v:
        raise ValueError("value does not fit 20 limbs")
    return out


def _limbs_to_int(limbs) -> int:
    v = 0
    for i in reversed(range(len(limbs))):
        v = (v << RADIX) | int(limbs[i])
    return v


_D_L = _int_to_limbs(D_INT)
_TWOD_L = _int_to_limbs(2 * D_INT % P)
_SQRT_M1_L = _int_to_limbs(SQRT_M1_INT)
_ONE_L = _int_to_limbs(1)


def _spread_8p() -> np.ndarray:
    """8p in radix-2^13 digits, spread so that every limb of the constant
    dominates any normalized operand limb (borrow-free subtraction: a - b
    computed as a + SPREAD_8P - b)."""
    e = _int_to_limbs(8 * P)
    e[0] += 1 << (RADIX + 1)
    for i in range(1, NLIMB - 1):
        e[i] += (1 << (RADIX + 1)) - 2
    e[NLIMB - 1] -= 2
    assert _limbs_to_int(e) == 8 * P
    return e


_SPREAD_8P = _spread_8p()


def _base_affine():
    gy = G_Y_INT
    u = (gy * gy - 1) % P
    v = (D_INT * gy * gy + 1) % P
    gx = (u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P)) % P
    if (v * gx * gx - u) % P != 0:
        gx = gx * SQRT_M1_INT % P
    if gx & 1 != 0:
        gx = P - gx
    return gx, gy


def _ed_add_affine(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    dxy = D_INT * x1 % P * x2 % P * y1 % P * y2 % P
    x3 = (x1 * y2 + x2 * y1) % P * pow(1 + dxy, P - 2, P) % P
    y3 = (y1 * y2 + x1 * x2) % P * pow(1 - dxy, P - 2, P) % P
    return x3, y3


def _build_base_window_table() -> List[np.ndarray]:
    """d*B for d=0..15 in niels form (y-x, y+x, 2d*x*y) → 3 arrays
    [16, 20]."""
    entries = [[_int_to_limbs(1), _int_to_limbs(1), _int_to_limbs(0)]]
    acc = None
    base = _base_affine()
    for _ in range(1, 16):
        acc = base if acc is None else _ed_add_affine(acc, base)
        x, y = acc
        entries.append([_int_to_limbs((y - x) % P), _int_to_limbs((y + x) % P),
                        _int_to_limbs(2 * D_INT * x % P * y % P)])
    return [np.stack([e[c] for e in entries]) for c in range(3)]


_NB_SUB, _NB_ADD, _NB_T2D = _build_base_window_table()


# --------------------------------- the plain version: field arithmetic
# A field element is a [20, ...] int64 tensor of radix-2^13 limbs, limb
# axis first; the limb discipline (carry rounds, the finalize after every
# add/sub, fcanon's single subtract) is ed25519_jax's, so every helper
# returns the same limbs as its JAX counterpart.

_COLS = torch.tensor([i + j for i in range(NLIMB) for j in range(NLIMB)],
                     dtype=torch.int64)


def _const(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(limbs, dtype=torch.int64, device=like.device)
    return t.view((NLIMB,) + (1,) * (like.dim() - 1)).expand_as(like)


def _shift_up(c):
    return torch.cat([torch.zeros_like(c[:1]), c[:-1]])


def _carry_round(c):
    return (c & MASK) + _shift_up(c >> RADIX)


def _carry_wrap_round(c):
    """Carry on 20 columns; the top carry wraps to column 0 times 608
    (2^260 ≡ 19·2^5 mod p)."""
    cr = c >> RADIX
    return (c & MASK) + torch.cat([cr[-1:] * 608, cr[:-1]])


def _finalize20(c):
    c = _carry_wrap_round(c)
    c = _carry_wrap_round(c)
    top = c[-1:] >> 8
    c = torch.cat([c[:1] + top * 19, c[1:-1], c[-1:] - (top << 8)])
    return _carry_wrap_round(c)


def fmul(a, b):
    outer = (a.unsqueeze(1) * b.unsqueeze(0)).reshape(
        (NLIMB * NLIMB,) + a.shape[1:])
    c = torch.zeros((2 * NLIMB + 2,) + a.shape[1:], dtype=torch.int64,
                    device=a.device)
    c.index_add_(0, _COLS.to(a.device), outer)
    c = _carry_round(_carry_round(_carry_round(c)))
    low = c[:20] + c[20:40] * 608
    extra = c[40:42] * (608 * 608)
    low = torch.cat([low[:2] + extra, low[2:]])
    return _finalize20(low)


def fsq(a):
    return fmul(a, a)


def fadd(a, b):
    return _finalize20(a + b)


def fsub(a, b):
    return _finalize20(a + _const(_SPREAD_8P, a) - b)


def fneg(a):
    return fsub(torch.zeros_like(a), a)


def fcanon(x):
    """Canonical representative in [0, p): conditional single subtract."""
    t = list(x.unbind(0))
    t[0] = t[0] + 19
    for k in range(NLIMB - 1):
        cr = t[k] >> RADIX
        t[k] = t[k] - (cr << RADIX)
        t[k + 1] = t[k + 1] + cr
    q = t[NLIMB - 1] >> 8
    r = list(x.unbind(0))
    r[0] = r[0] + q * 19
    r[NLIMB - 1] = r[NLIMB - 1] - (q << 8)
    for k in range(NLIMB - 1):
        cr = r[k] >> RADIX
        r[k] = r[k] - (cr << RADIX)
        r[k + 1] = r[k + 1] + cr
    return torch.stack(r)


def fiszero(x):
    return (fcanon(x) == 0).all(dim=0)


def feq(a, b):
    return fiszero(fsub(a, b))


def _sqn(x, n: int):
    for _ in range(n):
        x = fsq(x)
    return x


def pow_p58(x):
    """x^((p-5)/8), the ref10 pow22523 addition chain."""
    z2 = fsq(x)
    z9 = fmul(_sqn(z2, 2), x)
    z11 = fmul(z9, z2)
    z22 = fsq(z11)
    z_5_0 = fmul(z22, z9)
    z_10_0 = fmul(_sqn(z_5_0, 5), z_5_0)
    z_20_0 = fmul(_sqn(z_10_0, 10), z_10_0)
    z_40_0 = fmul(_sqn(z_20_0, 20), z_20_0)
    z_50_0 = fmul(_sqn(z_40_0, 10), z_10_0)
    z_100_0 = fmul(_sqn(z_50_0, 50), z_50_0)
    z_200_0 = fmul(_sqn(z_100_0, 100), z_100_0)
    z_250_0 = fmul(_sqn(z_200_0, 50), z_50_0)
    return fmul(_sqn(z_250_0, 2), x)


# ----------------------------------------------------- point arithmetic
# Extended twisted-Edwards coordinates (X, Y, Z, T), a = -1.

def pt_double(X, Y, Z, T):
    A = fsq(X)
    B = fsq(Y)
    C = fadd(fsq(Z), fsq(Z))
    E = fsub(fsub(fsq(fadd(X, Y)), A), B)
    G = fsub(B, A)
    F = fsub(G, C)
    H = fsub(fneg(A), B)
    return fmul(E, F), fmul(G, H), fmul(F, G), fmul(E, H)


def pt_add(X1, Y1, Z1, T1, X2, Y2, Z2, T2):
    A = fmul(fsub(Y1, X1), fsub(Y2, X2))
    B = fmul(fadd(Y1, X1), fadd(Y2, X2))
    C = fmul(fmul(T1, _const(_TWOD_L, T1)), T2)
    Dv = fadd(fmul(Z1, Z2), fmul(Z1, Z2))
    E = fsub(B, A)
    F = fsub(Dv, C)
    G = fadd(Dv, C)
    H = fadd(B, A)
    return fmul(E, F), fmul(G, H), fmul(F, G), fmul(E, H)


def pt_add_prescaled(X1, Y1, Z1, T1, X2, Y2, Z2, T2_2d):
    """pt_add where the second point's T is pre-multiplied by 2d."""
    A = fmul(fsub(Y1, X1), fsub(Y2, X2))
    B = fmul(fadd(Y1, X1), fadd(Y2, X2))
    C = fmul(T1, T2_2d)
    Dv = fmul(fadd(Z1, Z1), Z2)
    E = fsub(B, A)
    F = fsub(Dv, C)
    G = fadd(Dv, C)
    H = fadd(B, A)
    return fmul(E, F), fmul(G, H), fmul(F, G), fmul(E, H)


def pt_add_niels(X1, Y1, Z1, T1, n_sub, n_add, n_t2d):
    """Mixed addition with a (Y2-X2, Y2+X2, 2d*T2, Z2=1) niels point."""
    A = fmul(fsub(Y1, X1), n_sub)
    B = fmul(fadd(Y1, X1), n_add)
    C = fmul(T1, n_t2d)
    Dv = fadd(Z1, Z1)
    E = fsub(B, A)
    F = fsub(Dv, C)
    G = fadd(Dv, C)
    H = fadd(B, A)
    return fmul(E, F), fmul(G, H), fmul(F, G), fmul(E, H)


def decompress(ylimbs, sign):
    """(x, ok): recover x from y limbs and the sign bit; ok=False if y is
    not on the curve, or x = 0 with the sign bit set."""
    yy = fsq(ylimbs)
    one = _const(_ONE_L, ylimbs)
    u = fsub(yy, one)
    v = fadd(fmul(_const(_D_L, yy), yy), one)
    v2 = fsq(v)
    v3 = fmul(v2, v)
    v7 = fmul(fsq(v3), v)
    x = fmul(fmul(u, v3), pow_p58(fmul(u, v7)))
    vxx = fmul(v, fsq(x))
    is_root = feq(vxx, u)
    is_neg_root = fiszero(fadd(vxx, u))
    x = torch.where(is_neg_root & ~is_root,
                    fmul(x, _const(_SQRT_M1_L, x)), x)
    ok = is_root | is_neg_root
    xc = fcanon(x)
    x_zero = (xc == 0).all(dim=0)
    ok = ok & ~(x_zero & (sign == 1))
    parity = xc[0] & 1
    x = torch.where(parity != sign, fneg(xc), xc)
    return x, ok


def _digits4(words: torch.Tensor) -> torch.Tensor:
    """[B, 8] int32 (uint32 bit patterns) → [64, B] int64 4-bit digits,
    least significant digit first."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, 4, dtype=torch.int64, device=words.device)
    d = (w.unsqueeze(2) >> shifts) & 0xF               # [B, 8, 8]
    return d.reshape(words.shape[0], 64).t()


def _select(table: torch.Tensor, dig: torch.Tensor) -> torch.Tensor:
    """Per-signature pick from a [16, 20, B] table by digit [B] → [20, B]."""
    idx = dig.view(1, 1, -1).expand(1, NLIMB, dig.shape[0])
    return torch.gather(table, 0, idx)[0]


def verify_plain(ay, asign, ry, rsign, s_words, k_words) -> torch.Tensor:
    """Plain PyTorch verify, the same verdicts as the kernel. ay/ry:
    [B, 20] int32 limbs (canonical y < p); asign/rsign: [B] int32 sign
    bits; s_words/k_words: [B, 8] int32 little-endian u32 words → bool[B].

    Interleaved 4-bit windowed double-scalar multiplication: per window,
    4 doublings, one add from the constant d*B table and one from the
    per-signature d*(-A) table (T pre-scaled by 2d)."""
    ay = ay.to(torch.int64).t()
    ry = ry.to(torch.int64).t()
    asign = asign.to(torch.int64)
    rsign = rsign.to(torch.int64)
    ax, ok_a = decompress(ay, asign)
    rx, ok_r = decompress(ry, rsign)

    one = _const(_ONE_L, ay)
    zero = torch.zeros_like(ay)
    nax = fneg(ax)
    na = (nax, ay, one, fmul(nax, ay))
    tab = [(zero, one, one, zero), na]
    for d in range(2, 16):
        if d % 2 == 0:
            tab.append(pt_double(*tab[d // 2]))
        else:
            tab.append(pt_add(*tab[d - 1], *na))
    twod = _const(_TWOD_L, ay)
    a_table = [torch.stack([t[c] for t in tab]) for c in range(3)]
    a_table.append(torch.stack([fmul(t[3], twod) for t in tab]))
    dev = ay.device
    base = [torch.as_tensor(t, dtype=torch.int64, device=dev)
            for t in (_NB_SUB, _NB_ADD, _NB_T2D)]

    sd = _digits4(s_words)
    kd = _digits4(k_words)
    st = (zero, one, one, zero)
    for w in range(63, -1, -1):
        st = pt_double(*pt_double(*pt_double(*pt_double(*st))))
        st = pt_add_niels(*st, *(b[sd[w]].t() for b in base))
        st = pt_add_prescaled(*st, *(_select(t, kd[w]) for t in a_table))
    X, Y, Z, _ = st
    ok_x = fiszero(fsub(fmul(rx, Z), X))
    ok_y = fiszero(fsub(fmul(ry, Z), Y))
    return ok_a & ok_r & ok_x & ok_y


# ------------------------------------------------------------ the kernel

_ARGS = (("ay", (NLIMB,)), ("asign", ()), ("ry", (NLIMB,)), ("rsign", ()),
         ("s_words", (8,)), ("k_words", (8,)))


_SIGNATURES = {"ed25519_verify": [ctypes.c_void_p] * 7
               + [ctypes.c_int, ctypes.c_void_p]}


def verify_cuda(ay, asign, ry, rsign, s_words, k_words) -> torch.Tensor:
    """The CUDA kernel (csrc/ed25519_verify.cu) on CUDA int32 tensors,
    same arguments and verdicts as verify_plain (s and k below L, as
    host_pack leaves them). Launches 4 lanes for each of the B signatures
    on the current stream without synchronising; counts each launch in
    `verify_cuda.launches`."""
    args = (ay, asign, ry, rsign, s_words, k_words)
    B = int(ay.shape[0])
    dev = ay.device
    for t, (name, tail) in zip(args, _ARGS):
        if t.device != dev or dev.type != "cuda":
            raise ValueError("verify_cuda needs CUDA tensors on one device; "
                             "{} is on {}".format(name, t.device))
        check_arg(t, name, torch.int32, (B,) + tail)
    ok = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return ok != 0
    fn = cuda_lib.load("ed25519_verify", _SIGNATURES).ed25519_verify
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in args], ok.data_ptr(), B, stream)
    if err != 0:
        raise RuntimeError("ed25519_verify launch failed: CUDA error "
                           "{}".format(err))
    verify_cuda.launches += 1
    return ok != 0


verify_cuda.launches = 0


def verify(ay, asign, ry, rsign, s_words, k_words) -> torch.Tensor:
    """bool[B] verdicts: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if ay.device.type == "cuda":
        return verify_cuda(ay, asign, ry, rsign, s_words, k_words)
    if ay.device.type == "cpu":
        return verify_plain(ay, asign, ry, rsign, s_words, k_words)
    raise ValueError("unsupported device {}".format(ay.device))


# ----------------------------------------------------- host-side packing

def _bit_fold_matrix() -> np.ndarray:
    """[256, 20] f32: bit j of a little-endian 256-bit value contributes
    2^(j-13i) to limb i. Values stay < 2^13 — exact in f32."""
    m = np.zeros((256, NLIMB), dtype=np.float32)
    for j in range(256):
        i = j // RADIX
        if i < NLIMB:
            m[j, i] = float(1 << (j - RADIX * i))
    return m


_BIT_FOLD = _bit_fold_matrix()


def _le_words(a_bytes: np.ndarray) -> np.ndarray:
    """[B, 32] uint8 → [B, 4] uint64 little-endian words."""
    return a_bytes.view(np.uint64).reshape(a_bytes.shape[0], 4)


def _ge_const(words: np.ndarray, const: int) -> np.ndarray:
    """Vectorized (value >= const) over [B, 4] LE uint64 words."""
    cw = np.array([(const >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                   for i in range(4)], dtype=np.uint64)
    ge = np.zeros(words.shape[0], dtype=bool)
    decided = np.zeros(words.shape[0], dtype=bool)
    for i in (3, 2, 1, 0):  # most significant first
        gt = words[:, i] > cw[i]
        lt = words[:, i] < cw[i]
        ge |= gt & ~decided
        decided |= gt | lt
    ge |= ~decided  # equal ⇒ >=
    return ge


def _limbs_from_bytes(a_bytes: np.ndarray) -> np.ndarray:
    """[B, 32] uint8 (LE) → [B, 20] int32 radix-2^13 limbs, vectorized."""
    bits = np.unpackbits(a_bytes, axis=1, bitorder="little")  # [B, 256]
    return (bits.astype(np.float32) @ _BIT_FOLD).astype(np.int32)


def host_pack(msgs: Sequence[bytes], sigs: Sequence[bytes],
              verkeys: Sequence[bytes]):
    """Parse and canonicality-check signatures and keys, compute
    k = SHA-512(R||A||M) mod L, pack the limb arrays.

    → ([ay, asign, ry, rsign, s_words, k_words] numpy arrays, valid
    bool[B]); entries that fail a host check are packed as harmless
    placeholders and marked invalid."""
    n = len(msgs)
    if len(sigs) != n or len(verkeys) != n:
        raise ValueError("msgs, sigs and verkeys differ in length")
    valid = np.ones(n, dtype=bool)

    DUMMY_SIG = b"\x00" * 64
    DUMMY_VK = b"\x01" + b"\x00" * 31
    norm_sigs = []
    norm_vks = []
    for i in range(n):
        if len(sigs[i]) != 64 or len(verkeys[i]) != 32:
            valid[i] = False
            norm_sigs.append(DUMMY_SIG)
            norm_vks.append(DUMMY_VK)
        else:
            norm_sigs.append(bytes(sigs[i]))
            norm_vks.append(bytes(verkeys[i]))

    sig_b = np.frombuffer(b"".join(norm_sigs), dtype=np.uint8).reshape(n, 64)
    vk_b = np.frombuffer(b"".join(norm_vks), dtype=np.uint8).reshape(n, 32)
    r_b = np.ascontiguousarray(sig_b[:, :32])
    s_b = np.ascontiguousarray(sig_b[:, 32:])

    asign = (vk_b[:, 31] >> 7).astype(np.int32)
    rsign = (r_b[:, 31] >> 7).astype(np.int32)
    ay_b = vk_b.copy()
    ay_b[:, 31] &= 0x7F
    ry_b = r_b.copy()
    ry_b[:, 31] &= 0x7F

    # canonicality: y < p, s < L (vectorized big-int compares)
    bad = _ge_const(_le_words(ay_b), P) | _ge_const(_le_words(ry_b), P) \
        | _ge_const(_le_words(s_b), L)
    valid &= ~bad
    if bad.any():
        idx = np.nonzero(bad)[0]
        ay_b[idx] = 0
        ry_b[idx] = 0
        ay_b[idx, 0] = 1
        ry_b[idx, 0] = 1
        s_b = s_b.copy()
        s_b[idx] = 0

    k_parts = []
    for i in range(n):
        h = hashlib.sha512()
        h.update(norm_sigs[i][:32])
        h.update(norm_vks[i])
        h.update(msgs[i])
        k_int = int.from_bytes(h.digest(), "little") % L
        k_parts.append(k_int.to_bytes(32, "little"))
    k_b = np.frombuffer(b"".join(k_parts), dtype=np.uint8).reshape(n, 32)

    arrays = [_limbs_from_bytes(ay_b),
              asign,
              _limbs_from_bytes(ry_b),
              rsign,
              np.ascontiguousarray(s_b).view(np.uint32).reshape(n, 8),
              k_b.view(np.uint32).reshape(n, 8)]
    return arrays, valid


def launch_lanes(n: int, device=None) -> int:
    """The batch lanes a verify_batch_async(n) launch on `device` occupies:
    the mesh's padded size when the batch shards (ops/mesh.py), exactly n
    otherwise (the JAX package's power-of-two bucket served XLA's compile
    cache, which a CUDA kernel does not have). Single-sourced so that the
    coalescing hub accounts the lanes the launch pays for."""
    if n <= 0:
        return 0
    from plenum_tpu_torch.ops import mesh as mesh_mod
    m = mesh_mod.get_mesh()
    return m.padded_size(n) if m.should_shard(n, device) else n


def verify_batch_async(msgs: Sequence[bytes], sigs: Sequence[bytes],
                       verkeys: Sequence[bytes], device=None):
    """Non-blocking batched verify: packs on the host, launches on the
    device and returns (ok_device_tensor, valid_host_bools, n) at once; the
    caller materializes later (ok.cpu() & valid).

    A batch that clears the mesh gate (ops/mesh.py) is padded by
    repeating row 0 to the mesh's padded size and split over the mesh's
    devices, one launch each, its verdicts gathered onto `device` and cut
    to n; otherwise one launch covers exactly the n signatures."""
    dev = resolve_device(device)
    n = len(msgs)
    if n == 0:
        return None, np.zeros(0, dtype=bool), 0
    arrays, valid = host_pack(msgs, sigs, verkeys)
    from plenum_tpu_torch.ops import mesh as mesh_mod
    m = mesh_mod.get_mesh()
    if m.should_shard(n, dev):
        arrays = mesh_mod.pad_rows(arrays, m.padded_size(n))
        ok = m.gather(m.dispatch(verify, arrays, n=n), dev)[:n]
        return ok, valid, n
    m.note_passthrough(n)
    ok = verify(*[to_tensor(a, dev) for a in arrays])
    return ok, valid, n


def verify_batch(msgs: Sequence[bytes], sigs: Sequence[bytes],
                 verkeys: Sequence[bytes], device=None) -> np.ndarray:
    """Batched cofactorless ed25519 verify → np.bool_ array [B]."""
    ok, valid, n = verify_batch_async(msgs, sigs, verkeys, device)
    if n == 0:
        return np.zeros(0, dtype=bool)
    return ok.cpu().numpy() & valid
