"""K2, K2 lse, its key-norm pre-pass, K3, K3 lse, K4a and K4b at Phi-3's head
dim of 96 on the card (``Config<96, 2, 3>`` of
``csrc/decoder_attention_sm90.cuh`` and ``DkdvD96``/``DqD96`` of
``csrc/attention_bwd_sm90.cuh``: two 64-column boxes a row, the second half
TMA's zero fill), and the forms still refused there (K2r and its
pre-pass).

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_d96_sm90.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  Tolerances: each kernel output
within 2^-7 of max|plain| of its twin (one bf16 ulp of the largest output:
kernel and twin round p to bf16 alike and differ in fp32 summation order);
the pre-pass's kmax within 1e-6 of its twin and the same bits for every
chunk count; each K2 op bit-equal to the kernel alone on the standalone
kmax; two launches bit-identical; rows that see no key exactly 0.  The lse
forms: the lse within 1e-5 nats of the twin's on live rows (about 10x the
H100 reading at D = 128, ``chip_smoke.LSE_TOL``), 1e30 on dead rows, the
output bit-equal to the form without the lse.  K4a and K4b: each gradient
within 2^-7 of max|plain| of the twin's from the twin's lse, dq exactly 0
on dead rows, dk and dv exactly 0 on masked keys.
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa

D = 96
REL_TOL = 2 ** -7
PREPASS_REL_TOL = 1e-6
LSE_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


# (B, T, Hq, Hkv): a single token, each side of the 128-row q tile and the
# 128-key kv tile with GQA, and the 4B's (2, 3072, 32, 32).
K2_CASES = ((1, 1, 4, 4), (2, 127, 8, 8), (2, 129, 8, 2), (3, 200, 4, 4),
            (2, 3072, 32, 32))


def _decoder_inputs(gen, dev, B, T, Hq, Hkv):
    """q, k, v, a ragged (B, T) int32 mask (the last row masks its first 5
    keys and its last third: its first 5 queries see no key) and the dead
    rows."""
    q, k, v = (_randn(gen, dev, B, T, h, D) for h in (Hq, Hkv, Hkv))
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    if T > 8:
        mask[-1, :5] = 0
        mask[-1, T - T // 3:] = 0
    dead = mask.cumsum(1) == 0
    return q, k, v, mask, dead


def _rel(got, ref):
    top = ref.float().abs().max().item()
    return (got.float() - ref.float()).abs().max().item() / max(top, 1e-30)


@pytest.mark.cuda
def test_k2_op_and_kernel_alone_at_d96(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(20)
    for B, T, Hq, Hkv in K2_CASES:
        q, k, v, mask, dead = _decoder_inputs(g, cuda_device, B, T, Hq, Hkv)
        scale = D ** -0.5
        before = dict(kernels.launch_counts)
        got = kernels.decoder_attention_op(q, k, v, mask, None, scale)
        for name in ("decoder_attention", "key_norm_max",
                     "decoder_attention_d96", "key_norm_max_d96"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        again = kernels.decoder_attention_op(q, k, v, mask, None, scale)
        kmax = kernels.key_norm_max(k, mask)
        alone = kernels.decoder_attention(q, k, v, mask, kmax, None, scale)
        ref = fa.decoder_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        assert got.shape == (B, T, Hq, D) and torch.isfinite(got).all()
        assert torch.equal(got, alone), (B, T)
        assert torch.equal(got, again), (B, T)
        assert _rel(got, ref) <= REL_TOL, (B, T, _rel(got, ref))
        assert not got[dead].any()


@pytest.mark.cuda
def test_key_norm_max_at_d96_is_the_same_for_every_chunk_count(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(21)
    for B, T, _, Hkv in K2_CASES + ((1, 3072, 64, 64),):
        scale = torch.rand((B, T, Hkv, 1), generator=g, device=cuda_device)
        k = (_randn(g, cuda_device, B, T, Hkv, D).float()
             * (3 * scale + 0.2)).to(torch.bfloat16)
        mask = (torch.rand((B, T), generator=g, device=cuda_device)
                > 0.3).int()
        want = fa.key_norm_max(k, mask)
        got = kernels.key_norm_max(k, mask)
        assert _rel(got, want) <= PREPASS_REL_TOL, (B, T, Hkv)
        plan = kernels.key_norm_parts(B, T, Hkv, D)
        for parts in sorted({min(T, n) for n in (1, 2, 3, 7, plan, T)}):
            assert torch.equal(kernels.key_norm_max(k, mask, parts=parts),
                               got), (B, T, parts)


# (B, Q, K, Hq, Hkv, q_offset or None, causal): a prefill, a causal
# continuation at an offset, a decode step (Q = 1), and non-causal.
K3_CASES = ((2, 129, 129, 8, 2, None, True), (2, 200, 330, 4, 4, 130, True),
            (2, 1, 300, 8, 8, 299, True), (2, 129, 257, 8, 4, None, False),
            (2, 3072, 3072, 32, 32, None, True))


@pytest.mark.cuda
def test_k3_at_d96(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(22)
    for B, Q, K, Hq, Hkv, off, causal in K3_CASES:
        q = _randn(g, cuda_device, B, Q, Hq, D)
        k, v = (_randn(g, cuda_device, B, K, Hkv, D) for _ in range(2))
        mask = torch.ones((B, K), dtype=torch.int32, device=cuda_device)
        mask[-1, :7] = 0
        mask[0, K - 9:] = 0
        offset = (None if off is None else torch.full(
            (B,), off, dtype=torch.int32, device=cuda_device))
        before = dict(kernels.launch_counts)
        got = kernels.exact_attention(q, k, v, mask, offset, D ** -0.5,
                                      causal=causal)
        for name in ("exact_attention", "exact_attention_d96"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        again = kernels.exact_attention(q, k, v, mask, offset, D ** -0.5,
                                        causal=causal)
        ref = fa.exact_attention_plain(q, k, v, mask, offset, causal=causal)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert torch.equal(got, again), (B, Q, K)
        assert _rel(got, ref) <= REL_TOL, (B, Q, K, _rel(got, ref))
        dead = ~fa._allowed(q, k, mask, offset, causal).any(-1)
        assert not got[dead.expand(B, Q)].any()


def _check_lse(lse, ref_lse, dead):
    """dead: (B, Hq, Q) rows that see no key."""
    assert torch.equal(lse >= fa.DEAD_LSE * 0.5, dead)
    assert bool((lse[dead] == fa.DEAD_LSE).all())
    if (~dead).any():
        err = (lse - ref_lse)[~dead].abs().max().item()
        assert err <= LSE_TOL, err


# (B, T, Hq, Hkv, live keys or None): the 4B's training prompts (every key
# live), the reward gradient's single clip (1, 3072) with its prompt's
# 2,343 keys live, GQA at the tile edges, and K2_CASES' ragged (2, 3072).
K2_LSE_CASES = ((1, 799, 32, 32, None), (1, 3072, 32, 32, 2343),
                (2, 129, 8, 2, None), (2, 3072, 32, 32, "ragged"))


@pytest.mark.cuda
def test_k2_lse_at_d96(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(24)
    scale = D ** -0.5
    for B, T, Hq, Hkv, live in K2_LSE_CASES:
        q, k, v, mask, dead = _decoder_inputs(g, cuda_device, B, T, Hq, Hkv)
        if live != "ragged":
            mask.fill_(1)
            if live is not None:
                mask[:, live:] = 0
            dead = mask.cumsum(1) == 0
        before = dict(kernels.launch_counts)
        got, lse = kernels.decoder_attention_op(q, k, v, mask, None, scale,
                                                with_lse=True)
        for name in ("decoder_attention_lse", "decoder_attention_lse_d96",
                     "decoder_attention_d96", "key_norm_max_d96"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        again = kernels.decoder_attention_op(q, k, v, mask, None, scale,
                                             with_lse=True)
        plain = kernels.decoder_attention_op(q, k, v, mask, None, scale)
        alone = kernels.decoder_attention(q, k, v, mask,
                                          kernels.key_norm_max(k, mask), None,
                                          scale, with_lse=True)
        ref, ref_lse = fa.decoder_attention_plain(q, k, v, mask,
                                                  return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), (B, T)  # the lse changes no bit
        assert torch.equal(got, again[0]) and torch.equal(lse, again[1])
        assert torch.equal(got, alone[0]) and torch.equal(lse, alone[1])
        assert _rel(got, ref) <= REL_TOL, (B, T, _rel(got, ref))
        assert not got[dead].any()
        _check_lse(lse, ref_lse, dead[:, None, :].expand_as(lse))


# (relative offset, causal) of one shard's 768 queries over one chunk's 768
# keys at T = 3,072 over 4 shards, 32/32 heads of 96, the sequence's first 5
# keys masked: a later shard's chunk (every row dead), the diagonal, earlier
# chunks, and the non-causal form.
K3_LSE_OFFSETS = ((-768, True), (0, True), (768, True), (2304, True),
                  (0, False))


@pytest.mark.cuda
def test_k3_lse_at_d96_ring_chunks(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(25)
    L, scale = 768, D ** -0.5
    q, k, v = (_randn(g, cuda_device, 1, L, 32, D) for _ in range(3))
    for rel, causal in K3_LSE_OFFSETS:
        mask = torch.ones((1, L), dtype=torch.int32, device=cuda_device)
        if rel <= 0:  # the chunk holds the sequence's first keys
            mask[:, :5] = 0
        off = torch.full((1,), rel, dtype=torch.int32, device=cuda_device)
        before = dict(kernels.launch_counts)
        got, lse = kernels.exact_attention(q, k, v, mask, off, scale,
                                           causal=causal, with_lse=True)
        for name in ("exact_attention_lse", "exact_attention_lse_d96",
                     "exact_attention_d96"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        again = kernels.exact_attention(q, k, v, mask, off, scale,
                                        causal=causal, with_lse=True)
        plain = kernels.exact_attention(q, k, v, mask, off, scale,
                                        causal=causal)
        ref, ref_lse = fa.exact_attention_plain(q, k, v, mask, off,
                                                causal=causal,
                                                return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(got, plain) and torch.equal(got, again[0])
        assert torch.equal(lse, again[1])
        assert _rel(got, ref) <= REL_TOL, (rel, causal, _rel(got, ref))
        dead = ref_lse >= fa.DEAD_LSE * 0.5
        _check_lse(lse, ref_lse, dead)
        assert not got.transpose(1, 2)[dead].any()
        assert bool(dead.all()) == (rel < 0 and causal)


def _bwd_operands(g, dev, B, Q, K, Hq, Hkv, mask, off, causal):
    """q, k, v, a random dO, the twin's lse and delta, the mask and offset:
    the kernels' operands."""
    q, dout = _randn(g, dev, B, Q, Hq, D), _randn(g, dev, B, Q, Hq, D)
    k, v = _randn(g, dev, B, K, Hkv, D), _randn(g, dev, B, K, Hkv, D)
    out, lse = fa.exact_attention_plain(q, k, v, mask, off, causal=causal,
                                        return_lse=True)
    return (q, k, v, dout, lse.contiguous(), fa.attention_delta(out, dout),
            mask, off)


# (B, Q, K, Hq, Hkv, q_offset or None, causal): the 4B's training prompt,
# GQA at the tile edges with dead rows and masked keys, a ring chunk at an
# earlier shard's offset and a later one's, the all-gather shape, and the
# non-causal form.
K4_CASES = ((1, 799, 799, 32, 32, None, True), (2, 129, 129, 8, 2, None, True),
            (1, 768, 768, 32, 32, 768, True), (1, 768, 768, 32, 32, -768, True),
            (1, 768, 3072, 32, 32, 2304, True),
            (2, 193, 193, 8, 4, None, False))


@pytest.mark.cuda
def test_k4_at_d96(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(26)
    scale = D ** -0.5
    for B, Q, K, Hq, Hkv, o, causal in K4_CASES:
        mask = torch.ones((B, K), dtype=torch.int32, device=cuda_device)
        mask[-1, :5] = 0
        mask[0, K - 9:] = 0
        off = (None if o is None else torch.full(
            (B,), o, dtype=torch.int32, device=cuda_device))
        args = _bwd_operands(g, cuda_device, B, Q, K, Hq, Hkv, mask, off,
                             causal)
        before = dict(kernels.launch_counts)
        dk, dv = kernels.decoder_attention_bwd_dkdv(*args, scale, causal)
        dq = kernels.decoder_attention_bwd_dq(*args, scale, causal)
        for name in ("decoder_attention_bwd_dkdv", "decoder_attention_bwd_dq",
                     "decoder_attention_bwd_dkdv_d96",
                     "decoder_attention_bwd_dq_d96"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        dk2, dv2 = kernels.decoder_attention_bwd_dkdv(*args, scale, causal)
        dq2 = kernels.decoder_attention_bwd_dq(*args, scale, causal)
        want = fa.decoder_attention_bwd_plain(*args, causal=causal)
        torch.cuda.synchronize()
        case = (B, Q, K, o, causal)
        for name, got, again, w in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       (dq2, dk2, dv2), want):
            assert got.shape == w.shape and torch.isfinite(got).all(), name
            assert torch.equal(got, again), (name, case)
            assert _rel(got, w) <= REL_TOL, (name, case, _rel(got, w))
        dead = args[4] >= fa.DEAD_LSE * 0.5  # (B, Hq, Q)
        assert not dq.transpose(1, 2)[dead].any(), case
        masked = mask == 0
        assert not dk[masked].any() and not dv[masked].any(), case
        if o is not None and o < 0:
            assert not any(t.any() for t in (dq, dk, dv))


@pytest.mark.cuda
def test_autograd_at_d96_launches_the_lse_forms_and_k4(cuda_device):
    """Under autograd K2 and K3 take their lse forms and their backward
    K4a and K4b, on the card; their gradients lie within 2^-5 of max|plain|
    of fp32 autograd through the exact twin on the same bf16 inputs (the
    kernels round p and dS to bf16, as the TPU kernels do)."""
    g = torch.Generator(device=cuda_device).manual_seed(27)
    q, k, v = (_randn(g, cuda_device, 1, 200, 8, D) for _ in range(3))
    dout = _randn(g, cuda_device, 1, 200, 8, D)
    for fn, lse_name in ((fa.decoder_attention, "decoder_attention_lse_d96"),
                         (fa.exact_attention, "exact_attention_lse_d96")):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = dict(kernels.launch_counts)
        got = torch.autograd.grad(fn(*leaves), leaves, dout)
        for name in (lse_name, "decoder_attention_bwd_dkdv_d96",
                     "decoder_attention_bwd_dq_d96"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(
            fa.exact_attention_plain(*ref_leaves), ref_leaves, dout.float())
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            assert _rel(a, b) <= 4 * REL_TOL, (fn.__name__, name, _rel(a, b))


def _d96(dev, B=1, T=64, H=4):
    g = torch.Generator(device=dev).manual_seed(23)
    return (_randn(g, dev, B, T, H, D) for _ in range(3))


@pytest.mark.cuda
def test_forms_not_built_at_d96_refuse_before_any_launch(cuda_device):
    """K2r (the op and the kernel alone) and its pre-pass refuse D = 96
    before any check or launch, naming ROADMAP item 5c."""
    q, k, v = _d96(cuda_device)
    before = dict(kernels.launch_counts)
    calls = (
        lambda: kernels.decoder_attention_rows_op(q, k, v, None, None, 1.0),
        lambda: kernels.decoder_attention_rows(
            q, k, v, None, torch.zeros((1, 4, 64), device=cuda_device), None,
            1.0),
        lambda: kernels.key_norm_cummax(k),
        lambda: fa.decoder_attention_rows(q, k, v),
    )
    for call in calls:
        with pytest.raises(NotImplementedError, match="item 5c"):
            call()
    assert kernels.launch_counts == before


@pytest.mark.cuda
def test_c_entries_refuse_the_lse_at_d96(cuda_device):
    """The C entries now take the lse at D = 96 (K2's kernel alone and K3,
    causal and not) and K4a/K4b at 96; K2r's pre-pass and its kernel alone
    still refuse 96, and K4a/K4b refuse a head dim they are not built for
    (80)."""
    q, k, v = _d96(cuda_device)
    lib = kernels._load()
    out = torch.empty_like(q)
    lse = torch.empty((1, 4, 64), device=cuda_device)
    kmax = kernels.key_norm_max(k)
    stream = torch.cuda.current_stream().cuda_stream
    strides = (q.stride(0), q.stride(1)) * 3
    common = (1, 64, 64, 4, 4, D, *strides, 1.0)
    err = lib.mjv_decoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, kmax.data_ptr(),
        None, out.data_ptr(), lse.data_ptr(), *common, stream)
    assert err == 0
    for causal in (1, 0):
        err = lib.mjv_exact_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
            out.data_ptr(), lse.data_ptr(), *common, causal, stream)
        assert err == 0
    part = torch.empty((1, 1, 4), device=cuda_device)
    kcum = torch.empty((1, 4, 64), device=cuda_device)
    err = lib.mjv_key_norm_cummax(k.data_ptr(), None, part.data_ptr(),
                                  kcum.data_ptr(), 1, 64, 4, D, k.stride(0),
                                  k.stride(1), 1, stream)
    assert err != 0
    err = lib.mjv_decoder_attention_rows(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, kcum.data_ptr(),
        None, out.data_ptr(), *common, stream)
    assert err != 0
    torch.cuda.synchronize()
    dout = torch.zeros_like(q)
    delta = torch.zeros((1, 4, 64), device=cuda_device)
    lse.fill_(1.0)
    dk, dv, dq = (torch.empty_like(q) for _ in range(3))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), None, None)
    for head_dim, ok in ((D, True), (80, False)):
        tail = (1, 64, 64, 4, 4, head_dim, *strides, dout.stride(0),
                dout.stride(1), 1.0)
        err = lib.mjv_decoder_attention_bwd_dkdv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *tail, 1, stream)
        assert (err == 0) == ok, head_dim
        err = lib.mjv_decoder_attention_bwd_dq(
            *ptrs, dq.data_ptr(), *tail, 1, stream)
        assert (err == 0) == ok, head_dim
    torch.cuda.synchronize()
