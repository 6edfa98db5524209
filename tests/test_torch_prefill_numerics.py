"""The arithmetic of the tensor-core K7/K8 kernel (``csrc/attn_tc.cuh``)
emulated on the CPU, and the wrappers' path rule.

The kernel takes bf16 q, k, v; QK^T runs on the tensor cores into float32,
the online softmax runs in float32 in base 2 over key tiles of 128 (64 for
K7 at head dim 256, ``attn_tc::key_tile``), and P
goes through PV as two bf16 halves, ``p_hi = bf16(p)`` and ``p_lo = bf16(p -
p_hi)``, into one float32 accumulator; the output is rounded to bf16 once.
:func:`emulate` does the same in float32 PyTorch. It is held, over the
reference's K7 prefill cases and K8 chunk packs at small widths, against the
JAX package's Pallas kernels in interpret mode and the port's plain versions
at the bound the card's checks use (``chip_smoke.py``,
``tests/test_torch_kernels_cuda.py::_bf16_close``): one bf16 step of the
output (2**-7 of |ref|) plus 2e-5.

Measured on these inputs (largest |out - ref| as a share of the bound,
against the JAX kernel): the split lands at 0.81-0.95 of it on the K7 cases
at d 64 and 128, 0.95-0.98 on those at d 256 (64-key tiles), and 0.49-0.97
on the K8 packs -- a rounding flip of one bf16 step, which stays below 1 by
construction (one bf16 step of x is at most 2**-7 |x|). A single bf16 copy
of P (8 significant bits instead of about 16) lands at 16-63x the bound on
the K7 cases and 28-37x on the K8 packs, so it would
fail the unchanged checks; ``test_single_bf16_p_misses_the_bound`` keeps
that finding true.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill import flash_prefill as jflash_prefill  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill_paged as jflash_prefill_paged  # noqa: E402
from repro_torch.core.attention import paged_gather_kv  # noqa: E402
from repro_torch.kernels import flash_prefill as tfp  # noqa: E402

BF16_STEP = 2.0 ** -7
ATOL = 2e-5
TILE = 128                  # the kernel's key tile at d 64 and 128
LOG2E = 1.4426950408889634


def _tile(d):
    """The key tile of the row block at head dim d (attn_tc::key_tile)."""
    return 64 if d == 256 else TILE

# the reference's PREFILL_CASES (tests/test_kernels.py:130-136) at the
# tensor-core head dims, a block straddling two query heads (Lq 100, g 4),
# a ragged tail (Lk 300), rows before position 0 (q_offset -20), and a
# window over several tiles: (B, Hq, Hkv, Lq, Lk, d, causal, window, q_offset)
K7_CASES = [
    (2, 4, 2, 64, 64, 64, True, None, 0),
    (1, 4, 4, 100, 100, 64, True, 32, 0),
    (2, 2, 1, 37, 150, 128, False, None, 0),
    (1, 8, 2, 128, 256, 64, True, None, 128),
    (1, 8, 2, 100, 300, 128, True, None, 200),
    (1, 4, 1, 70, 50, 128, True, None, -20),
    (1, 4, 2, 300, 300, 64, True, 160, 0),
    # d 256 on 64-key tiles (gemma-3's head dim): causal; a window spanning
    # several tiles; a query offset; GQA g 4 with a row block straddling two
    # query heads (g Lq = 4 x 70 rows); a window narrower than one tile
    (1, 2, 1, 130, 130, 256, True, None, 0),
    (1, 2, 1, 200, 200, 256, True, 100, 0),
    (1, 2, 1, 60, 190, 256, True, None, 130),
    (1, 8, 2, 70, 70, 256, True, None, 0),
    (1, 2, 2, 150, 150, 256, True, 40, 0),
]
# (Hq, Hkv, d, page, offs, lens): pages of 16, 128 and 24 (not a divisor of
# the tile), chunks at fresh, mid-page and page-aligned offsets
K8_CASES = [
    (4, 2, 64, 16, (0, 9, 33), (5, 3, 5)),
    (8, 2, 128, 128, (200, 37), (64, 64)),
    (4, 1, 64, 24, (50, 3), (40, 17)),
]


def _bf(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def emulate(q, k, v, visible, scale, split=True, tile=TILE):
    """The kernel's arithmetic. ``q (..., R, d)``, ``k/v (..., K, d)`` bf16,
    ``visible (..., R, K)`` bool. Key tiles of ``tile`` in order; masked
    scores weigh exactly 0; ``split=False`` puts one bf16 copy of P through
    PV. Returns ``(..., R, d)`` bf16."""
    qf, kf, vf = q.float(), k.float(), v.float()
    R, K = visible.shape[-2:]
    acc = torch.zeros(*qf.shape[:-1], vf.shape[-1])
    m = torch.full(qf.shape[:-1], -1e30)
    l = torch.zeros(qf.shape[:-1])
    for k0 in range(0, K, tile):
        ok = visible[..., k0:k0 + tile]
        s = (qf @ kf[..., k0:k0 + tile, :].transpose(-1, -2)) * (scale * LOG2E)
        s = torch.where(ok, s, torch.tensor(-math.inf))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(-1)
        vt = vf[..., k0:k0 + tile, :]
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = alpha[..., None] * acc + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)


def _k7_visible(Lq, Lk, causal, window, q_offset):
    qpos = q_offset + torch.arange(Lq)[:, None]
    kpos = torch.arange(Lk)[None, :]
    ok = torch.ones(Lq, Lk, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def _k7_case(case, seed):
    B, Hq, Hkv, Lq, Lk, d, causal, window, q_offset = case
    rng = np.random.default_rng(seed)
    q, k, v = _bf(rng, (B, Hq, Lq, d)), _bf(rng, (B, Hkv, Lk, d)), _bf(rng, (B, Hkv, Lk, d))
    g = Hq // Hkv
    emu = lambda split: _np(emulate(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
        _k7_visible(Lq, Lk, causal, window, q_offset), 1.0 / math.sqrt(d), split, _tile(d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref_j = _np(jflash_prefill(_j(q), _j(k), _j(v), interpret=True, **kw))
    ref_t = _np(tfp.flash_prefill(q, k, v, **kw))
    return emu, ref_j, ref_t


def _k8_case(case, seed):
    Hq, Hkv, d, page, offs, lens = case
    rng = np.random.default_rng(seed)
    N, C = len(offs), max(lens)
    n_pages = [-(-(o + n) // page) for o, n in zip(offs, lens)]
    W = max(n_pages) + 1
    num_pages = 1 + sum(n_pages)
    perm = rng.permutation(np.arange(1, num_pages))
    tbl = np.zeros((N, W), np.int32)
    j = 0
    for n, npg in enumerate(n_pages):
        tbl[n, :npg] = perm[j:j + npg]
        j += npg
    kp, vp = _bf(rng, (num_pages, Hkv, page, d)), _bf(rng, (num_pages, Hkv, page, d))
    q = _bf(rng, (N, Hq, C, d))
    tbl_t, off_t = torch.from_numpy(tbl), torch.tensor(offs, dtype=torch.int32)
    g = Hq // Hkv
    kd = paged_gather_kv(kp, tbl_t).repeat_interleave(g, 1)        # (N, Hq, W*page, d)
    vd = paged_gather_kv(vp, tbl_t).repeat_interleave(g, 1)
    qpos = off_t[:, None].long() + torch.arange(C)[None, :]
    visible = (torch.arange(W * page)[None, None, :] <= qpos[..., None])[:, None]
    emu = lambda split: emulate(q, kd, vd, visible.expand(N, Hq, C, W * page),
                                1.0 / math.sqrt(d), split)
    ref_j = _np(jflash_prefill_paged(_j(q), _j(kp), _j(vp), jnp.asarray(tbl),
                                     jnp.asarray(np.asarray(offs, np.int32)), interpret=True))
    ref_t = _np(tfp.flash_prefill_paged(q, kp, vp, tbl_t, off_t))
    # rows of chunk padding are garbage the callers discard
    rows = lambda x: np.concatenate([x[n, :, :L].reshape(-1) for n, L in enumerate(lens)])
    return (lambda split: rows(_np(emu(split)))), rows(ref_j), rows(ref_t)


def _worst(out, ref):
    """Largest |out - ref| as a share of the bound 2**-7 |ref| + 2e-5."""
    return float(np.max(np.abs(out - ref) / (BF16_STEP * np.abs(ref) + ATOL)))


@pytest.mark.parametrize("case", K7_CASES)
def test_k7_split_p_within_one_bf16_step(case):
    emu, ref_j, ref_t = _k7_case(case, seed=sum(case[:6]))
    out = emu(True)
    assert np.isfinite(out).all()
    assert _worst(out, ref_j) <= 1.0
    assert _worst(out, ref_t) <= 1.0


@pytest.mark.parametrize("case", K8_CASES)
def test_k8_split_p_within_one_bf16_step(case):
    emu, ref_j, ref_t = _k8_case(case, seed=case[3])
    out = emu(True)
    assert np.isfinite(out).all()
    assert _worst(out, ref_j) <= 1.0
    assert _worst(out, ref_t) <= 1.0


def test_single_bf16_p_misses_the_bound():
    """The finding in the module docstring: over the cases, one bf16 copy
    of P lands past the bound the split stays within."""
    single = [_worst(emu(False), ref_j) for emu, ref_j, _ in
              [_k7_case(c, seed=sum(c[:6])) for c in K7_CASES]
              + [_k8_case(c, seed=c[3]) for c in K8_CASES]]
    assert max(single) > 1.0


def test_path_rule():
    bf, f32 = torch.bfloat16, torch.float32
    assert tfp.tensor_core_path(bf, 128) and tfp.tensor_core_path(bf, 64)
    assert tfp.tensor_core_path(bf, 128, 128) and tfp.tensor_core_path(bf, 64, 24)
    assert tfp.tensor_core_path(bf, 128, 256)
    # K7 (no page) at d 256 runs on the tensor cores, on 64-key tiles; K8
    # and the fused K4 (a page given) at d 256 keep the CUDA cores
    assert tfp.tensor_core_path(bf, 256)
    for page in (8, 16, 128, 256):
        assert not tfp.tensor_core_path(bf, 256, page)
    # float32 keeps the CUDA-core kernel (TF32 would break the 2e-5
    # contract), and so does bf16 at other head dims
    assert not tfp.tensor_core_path(f32, 128) and not tfp.tensor_core_path(f32, 128, 12)
    assert not tfp.tensor_core_path(f32, 256)
    for d in (16, 32, 96, 512):
        assert not tfp.tensor_core_path(bf, d) and not tfp.tensor_core_path(bf, d, 12)
    # K8 on a page that is not a multiple of 8 rows takes the CUDA-core
    # kernel, which takes any page (the engine picks 100 for a 100-token cache)
    for page in (12, 100):
        assert not tfp.tensor_core_path(bf, 128, page)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and count no
    launch, tensor-core or other, whatever the path rule says."""
    rng = np.random.default_rng(3)
    q, k = _bf(rng, (1, 4, 10, 128)), _bf(rng, (1, 2, 10, 128))
    tfp.reset_launch_counts()
    out = tfp.flash_prefill(q, k, k)
    assert torch.equal(out, tfp.flash_prefill_plain(q, k, k))
    kp = _bf(rng, (3, 2, 16, 128))
    tbl, off = torch.tensor([[1, 2]], dtype=torch.int32), torch.tensor([4], dtype=torch.int32)
    tfp.flash_prefill_paged(_bf(rng, (1, 4, 8, 128)), kp, kp, tbl, off)
    assert (tfp.dense_launches, tfp.dense_tc_launches, tfp.launches, tfp.tc_launches) == (0,) * 4
