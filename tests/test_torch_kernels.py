"""The port's CUDA kernels against their plain PyTorch versions, and the
wrappers' input checks. Imports neither JAX nor airpose_tpu, so that on a
machine with a card (where JAX need not be installed) the tests run with

  python -m pytest tests/test_torch_kernels.py --noconftest -q

The tests marked ``cuda`` skip where no CUDA device is present."""

import numpy as np
import pytest
import torch

from airpose_tpu_torch.bodymodel import cuda_lbs
from airpose_tpu_torch.models.resnet import ResNet50
from airpose_tpu_torch.ops import fused_bottleneck as fb
from airpose_tpu_torch.ops import int8_bottleneck as ib
from airpose_tpu_torch.ops import int8_conv as ic
from airpose_tpu_torch.ops import int8_stem as st


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def stage_ops():
    """Folded layer1 operands of a seeded trunk with BN statistics moved off
    (0, 1), on the CPU."""
    rng = np.random.default_rng(0)
    sd = ResNet50(generator=torch.Generator().manual_seed(0)).state_dict()
    for k in sd:
        if k.startswith("layer1.") and k.endswith("running_mean"):
            sd[k] += torch.from_numpy(rng.normal(0, 0.05, sd[k].shape).astype(np.float32))
        elif k.startswith("layer1.") and k.endswith("running_var"):
            sd[k] *= torch.from_numpy(rng.uniform(0.8, 1.2, sd[k].shape).astype(np.float32))
    return fb.stage1_params_from_state_dict(sd)


def _skin_inputs(V, B, J, device, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random((V, J)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    a = rng.normal(size=(B, J, 4, 4)).astype(np.float32) * 0.3
    a[:, :, 3] = [0, 0, 0, 1]
    p = rng.normal(size=(B, V, 3)).astype(np.float32)
    return tuple(torch.from_numpy(t).to(device) for t in (w, a, p))


def test_skinning_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lbs.skinning_cuda(*_skin_inputs(8, 1, 2, "cpu"))


@pytest.mark.parametrize("J", [0, 257])
def test_skinning_cuda_rejects_joint_counts(J):
    """The joint count is checked before anything touches a device."""
    w, a, p = (torch.zeros(s) for s in ((8, J), (1, J, 4, 4), (1, 8, 3)))
    with pytest.raises(ValueError, match="joints"):
        cuda_lbs.skinning_cuda(w, a, p)


@pytest.mark.parametrize("arg", [0, 1, 2])
def test_skinning_cuda_rejects_grad(arg):
    """The skinning weights take no gradient: asking for one raises before
    anything touches a device. The transforms and the posed vertices do take
    one, so on CPU tensors they meet the device check like any input."""
    inputs = list(_skin_inputs(8, 1, 2, "cpu"))
    inputs[arg].requires_grad_(True)
    if arg == 0:
        with pytest.raises(RuntimeError, match="lbs_weights takes no gradient"):
            cuda_lbs.skinning_cuda(*inputs)
    else:
        with pytest.raises(ValueError, match="CUDA"):
            cuda_lbs.skinning_cuda(*inputs)


def test_fused_stage1_cuda_rejects_cpu_tensors(stage_ops):
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_stage1_cuda(torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16), stage_ops)


@pytest.mark.cuda
@pytest.mark.parametrize("V,B,J", [
    (10475, 128, 55),   # the main path
    (1000, 9, 55),
    (77, 3, 24),
    (500, 5, 256),      # the wrapper's limit: 8 chunks of 32 joints
    (2000, 7, 24),      # one chunk of 64 joints, ragged
    (2000, 7, 33),
    (2000, 7, 64),      # the largest one-chunk J
    (2000, 7, 65),      # a 1-joint first chunk, then two of 32
    (3000, 40, 100),    # 4 chunks a tile; a block's run crosses vertex tiles
    (10475, 60, 55),    # the training batch
    (10475, 17, 55),    # V and B multiples of neither the tile nor 4
])
def test_skinning_kernel_matches_reference(cuda, V, B, J):
    w, a, p = _skin_inputs(V, B, J, cuda)
    n = cuda_lbs.launches
    got = cuda_lbs.skinning(w, a, p)
    assert cuda_lbs.launches == n + 1
    torch.testing.assert_close(got, cuda_lbs.skinning_reference(w, a, p),
                               atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("V,B,J", [
    (10475, 60, 55),    # the training step's bodies: 30 frames × 2 views
    (1000, 9, 24),
])
def test_skinning_kernel_gradient(cuda, V, B, J):
    """The Function's gradients (kernel forward, torch-ops backward) against
    autograd through the plain version: f32 sums in other orders, bound on
    max |difference| / max |reference| of each gradient."""
    w, a, p = _skin_inputs(V, B, J, cuda)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(B, V, 3)).astype(np.float32)
                         ).to(cuda)
    a, p = a.requires_grad_(True), p.requires_grad_(True)
    n = cuda_lbs.launches
    got = torch.autograd.grad(cuda_lbs.skinning(w, a, p), (a, p), g)
    assert cuda_lbs.launches == n + 1
    want = torch.autograd.grad(cuda_lbs.skinning_reference(w, a, p), (a, p), g)
    for x, y in zip(got, want):
        assert ((x - y).abs().max() / y.abs().max()).item() <= 1e-5
    assert torch.equal(got[0][:, :, 3], torch.zeros_like(got[0][:, :, 3]))


@pytest.mark.cuda
def test_skinning_kernel_takes_unaligned_views(cuda):
    """W is read by 4-byte copies and p through the aligned span around it,
    so views at any float offset work; A is read by 16-byte copies, so the
    wrapper refuses a misaligned one."""
    V, B, J = 1001, 5, 55
    w, a, p = _skin_inputs(V, B, J, cuda)
    big_p = torch.empty(B * V * 3 + 1, device=cuda)
    big_w = torch.empty(V * J + 3, device=cuda)
    p1 = big_p[1:].view(B, V, 3).copy_(p)
    w1 = big_w[3:].view(V, J).copy_(w)
    assert p1.data_ptr() % 16 and w1.data_ptr() % 16
    torch.testing.assert_close(cuda_lbs.skinning(w1, a, p1),
                               cuda_lbs.skinning_reference(w, a, p), atol=2e-5, rtol=0)
    big_a = torch.empty(a.numel() + 1, device=cuda)
    a1 = big_a[1:].view(a.shape).copy_(a)
    with pytest.raises(ValueError, match="aligned"):
        cuda_lbs.skinning(w, a1, p)


@pytest.mark.cuda
def test_skinning_kernel_rejects_bad_inputs(cuda):
    w, a, p = _skin_inputs(100, 2, 55, cuda)
    with pytest.raises(ValueError, match="float32"):
        cuda_lbs.skinning(w.double(), a, p)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lbs.skinning(w, a, p.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_lbs.skinning(w.cpu(), a, p)
    with pytest.raises(ValueError, match="joints"):
        cuda_lbs.skinning(torch.zeros(100, 257, device=cuda),
                          torch.zeros(2, 257, 4, 4, device=cuda), p)
    with pytest.raises(RuntimeError, match="lbs_weights takes no gradient"):
        cuda_lbs.skinning(w.clone().requires_grad_(True), a, p)


@pytest.mark.cuda
@pytest.mark.parametrize("J", [55, 64, 65, 256])
def test_skinning_kernel_resources(cuda, J):
    """One resident block an SM, without spilling past the register file,
    on both sides of the 64-joint switch of the chunk size."""
    res = cuda_lbs.kernel_resources(J)
    assert res["blocks_per_sm"] == 1 and res["registers"] <= 255, res
    assert res["smem_bytes"] <= 232448, res


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,w", [
    (4, 56, 56),
    (3, 9, 13),     # a last band of 1 row, narrow rows
    (1, 56, 56),    # 14 bands: fewer than the persistent grid's blocks
    (2, 30, 56),    # H not a multiple of the band height
    (1, 7, 128),    # the widest rows, in bands of one row
])
def test_fused_stage1_kernel_matches_reference(cuda, stage_ops, B, h, w):
    ops = [{k: v.to(cuda) for k, v in blk.items()} for blk in stage_ops]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.abs(rng.normal(size=(B, h, w, 64))).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    n = fb.launches
    got = fb.fused_stage1(x, ops)
    assert fb.launches == n + 3
    torch.testing.assert_close(got.float(), fb.fused_stage1_reference(x, ops).float(),
                               atol=0.05, rtol=0.05)


@pytest.mark.cuda
def test_fused_stage1_kernel_rejects_bad_inputs(cuda, stage_ops):
    ops = [{k: v.to(cuda) for k, v in blk.items()} for blk in stage_ops]
    with pytest.raises(ValueError, match="bfloat16"):
        fb.fused_stage1(torch.zeros(1, 8, 8, 64, device=cuda), ops)
    with pytest.raises(ValueError, match="width"):
        fb.fused_stage1(torch.zeros(1, 8, 200, 64, device=cuda, dtype=torch.bfloat16), ops)


def _int8_conv_inputs(N, H, W, cin, cout, ksize, stride, mode, device, seed=0):
    """x, w, m, b and the epilogue keywords of one ``mode``; m scales a typical
    accumulator into ~[-60, 60], so the requant modes' scale 0.3 clips."""
    rng = np.random.default_rng(seed)
    K = ksize * ksize * cin
    x = rng.integers(-127, 128, size=(N, H, W, cin)).astype(np.int8)
    w = rng.integers(-127, 128, size=(cout, K)).astype(np.int8)
    m = (rng.uniform(0.5, 1.5, cout) * 20.0 / (np.sqrt(K) * 127 * 73)).astype(np.float32)
    b = rng.normal(0, 5.0, cout).astype(np.float32)
    t = {k: torch.from_numpy(v).to(device) for k, v in (("x", x), ("w", w), ("m", m), ("b", b))}
    ho, wo = ic.out_size(H, ksize, stride), ic.out_size(W, ksize, stride)
    res_shape = (N, ho, wo, cout)
    kw = {"requant": dict(relu=True),
          "f32": dict(out_dtype=torch.float32),
          "block_end": dict(res=torch.from_numpy(rng.integers(0, 128, size=res_shape).astype(np.int8)),
                            r=torch.tensor(0.37), relu=True),
          "block_end_bf16": dict(res=torch.from_numpy(rng.normal(0, 20, res_shape).astype(np.float32)),
                                 relu=True, out_dtype=torch.bfloat16),
          "qconv": dict(res=torch.from_numpy(rng.normal(0, 20, res_shape).astype(np.float32)
                                             ).to(torch.bfloat16),
                        relu=True, out_dtype=torch.bfloat16),
          # the static int8 trunk: conv1/conv2 write int8 at the next conv's
          # scale; conv3 writes the bf16 block output and its int8
          "qconv_quant": dict(relu=True, out_dtype=torch.int8, qscale=0.3),
          "qconv_dual": dict(res=torch.from_numpy(rng.normal(0, 20, res_shape).astype(np.float32)
                                                  ).to(torch.bfloat16),
                             relu=True, out_dtype=torch.bfloat16, qscale=0.3)}[mode]
    kw = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in kw.items()}
    return t, kw


def _int8_block_operands(cin, cmid, cout, stride, out_int8, device, seed=0):
    """Random block operands in the kernel's layout, scaled so that each
    requantized map spans the int8 range."""
    rng = np.random.default_rng(seed)

    def conv(co, k):
        w = torch.from_numpy(rng.integers(-127, 128, size=(co, k)).astype(np.int8))
        m = torch.from_numpy((rng.uniform(0.5, 1.5, co) * 40.0 / (np.sqrt(k) * 127 * 64)
                              ).astype(np.float32))
        return w, m, torch.from_numpy(rng.normal(0, 5.0, co).astype(np.float32))

    blk = {"stride": stride, "out_int8": out_int8}
    for i, (co, k) in enumerate(((cmid, cin), (cmid, 9 * cmid), (cout, cmid)), 1):
        blk[f"w{i}"], blk[f"m{i}"], blk[f"b{i}"] = conv(co, k)
    if stride == 2:
        blk["wp"], blk["mp"], blk["bp"] = conv(cout, cin)
    else:
        blk["r"] = torch.tensor(0.8)
    return {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in blk.items()}


def test_int8_conv_cuda_rejects_cpu_tensors():
    t, kw = _int8_conv_inputs(1, 4, 4, 32, 8, 1, 1, "requant", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ic.int8_conv_cuda(t["x"], t["w"], t["m"], t["b"], 1, 1, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["requant", "f32", "block_end", "block_end_bf16", "qconv",
                                  "qconv_quant", "qconv_dual"])
@pytest.mark.parametrize("ksize,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("N,H,W,cin,cout", [(3, 9, 13, 96, 40), (4, 28, 28, 256, 512)])
def test_int8_conv_kernel_matches_reference(cuda, N, H, W, cin, cout, ksize, stride, mode):
    """Exact: integer accumulation and the same f32 operations, each
    rounded on its own."""
    t, kw = _int8_conv_inputs(N, H, W, cin, cout, ksize, stride, mode, cuda)
    n = ic.launches
    got = ic.int8_conv(t["x"], t["w"], t["m"], t["b"], ksize, stride, **kw)
    assert ic.launches == n + 1
    want = ic.int8_conv_reference(t["x"], t["w"], t["m"], t["b"], ksize, stride, **kw)
    torch.cuda.synchronize()
    pairs = zip(got, want) if mode == "qconv_dual" else [(got, want)]
    for g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (g.float() - w.float()).abs().max().item()
    if "qconv_" in mode:
        q = want[1] if mode == "qconv_dual" else want
        assert (q.abs() == 127).any() and (q == 0).any(), "the clip or relu is not exercised"


@pytest.mark.cuda
@pytest.mark.parametrize("s", [0.3, 1 / 3, 0.0123, 2.0 ** -5 * 1.5, 7.77])
def test_int8_conv_requant_every_bf16_value(cuda, s):
    """The requant epilogue equals the plain version's IEEE division on every
    finite bf16 value within ±130·s and on a few far beyond, one output
    channel each: a 1×1 conv of one pixel whose accumulator is 1, so that
    channel c's value is m[c]."""
    v = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    v = v.view(torch.bfloat16).float()
    v = v[torch.isfinite(v) & (v.abs() <= 130 * s)]
    v = torch.cat([v, torch.tensor([200 * s, -200 * s, 1e30, -1e30, 3e38])])
    m = torch.cat([v, torch.zeros((-len(v)) % 8)]).to(cuda)
    x = torch.zeros(1, 1, 1, 32, dtype=torch.int8, device=cuda)
    x[..., 0] = 1
    w = torch.zeros(len(m), 32, dtype=torch.int8, device=cuda)
    w[:, 0] = 1
    b = torch.zeros_like(m)
    for out_dtype in (torch.int8, torch.bfloat16):
        got = ic.int8_conv(x, w, m, b, 1, out_dtype=out_dtype, qscale=s)
        want = ic.int8_conv_reference(x, w, m, b, 1, out_dtype=out_dtype, qscale=s)
        torch.cuda.synchronize()
        for g, wt in zip(*((got, want) if out_dtype == torch.bfloat16 else ((got,), (want,)))):
            assert torch.equal(g, wt), (g.float() - wt.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cmid,cout,stride,out_int8,hw", [
    (256, 128, 512, 2, True, 56),      # layer2_0: projection, stride 2
    (512, 128, 512, 1, True, 28),      # layer2_1: identity
    (2048, 512, 2048, 1, False, 7),    # layer4_2: the bf16-final block
], ids=["projection", "identity", "bf16_final"])
def test_int8_block_kernel_matches_reference(cuda, cin, cmid, cout, stride, out_int8, hw):
    blk = _int8_block_operands(cin, cmid, cout, stride, out_int8, cuda)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 128, size=(4, hw, hw, cin)).astype(np.int8)).to(cuda)
    nb, nc = ib.launches, ic.launches
    got = ib.int8_block(x, blk)
    assert ib.launches == nb + 1 and ic.launches == nc + (4 if stride == 2 else 3)
    want = ib.int8_block_reference(x, blk)
    torch.cuda.synchronize()
    assert got.dtype == (torch.int8 if out_int8 else torch.bfloat16)
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= 1.0 and (diff > 0).float().mean().item() < 5e-3
    assert float(want.float().abs().mean()) > 1.0, "the block output is trivially small"


@pytest.mark.cuda
def test_int8_conv_kernel_rejects_bad_inputs(cuda):
    t, kw = _int8_conv_inputs(2, 8, 8, 64, 64, 3, 1, "requant", cuda)
    x, w, m, b = t["x"], t["w"], t["m"], t["b"]
    with pytest.raises(ValueError, match="int8"):
        ic.int8_conv(x.float(), w, m, b, 3, **kw)
    with pytest.raises(ValueError, match="float32"):
        ic.int8_conv(x, w, m.double(), b, 3, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ic.int8_conv(x.transpose(1, 2).contiguous().transpose(1, 2), w, m, b, 3, **kw)
    with pytest.raises(ValueError, match="multiple of 32"):
        ic.int8_conv(x[..., :48].contiguous(), w[:, :9 * 48].contiguous(), m, b, 3, **kw)
    with pytest.raises(ValueError, match="stride"):
        ic.int8_conv(x, w, m, b, 3, 3, **kw)
    with pytest.raises(ValueError, match="scale r"):
        ic.int8_conv(x, w, m, b, 3, res=torch.zeros_like(x))
    with pytest.raises(ValueError, match="qscale"):
        ic.int8_conv(x, w, m, b, 3, out_dtype=torch.float32, qscale=0.3)
    with pytest.raises(ValueError, match="qscale"):
        ic.int8_conv(x, w, m, b, 3, out_dtype=torch.int8, qscale=0.0)
    blk = _int8_block_operands(64, 32, 64, 2, True, cuda)
    with pytest.raises(ValueError, match="even"):
        ib.int8_block(torch.zeros(1, 7, 8, 64, dtype=torch.int8, device=cuda), blk)


# Share of the stem's outputs the kernel may flip against a plain version
# that sums the conv in another order (chip_smoke.py's STEM_STEP_SHARE).
STEM_STEP_SHARE = 1e-3


def _stem_inputs(n, h, w, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, 3, generator=g)
    wt = (torch.randn(64, 3, 7, 7, generator=g) * 0.1).to(torch.bfloat16)
    b = torch.randn(64, generator=g) * 0.1
    return x.to(device), wt.to(device), b.to(device)


def test_int8_stem_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        st.stem_cuda(*_stem_inputs(1, 16, 16, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w", [(1, 224, 224), (3, 64, 64), (2, 37, 51)])
def test_int8_stem_kernel_matches_ordered_and_plain(cuda, n, h, w):
    """The fused stem (conv, pool, bias, relu) against the plain version and
    against the fixed-order conv followed by the same pool, bias and relu:
    the tensor cores sum in their own order, so each output lies within one
    bf16 step of the other's pre-bias pooled value (``one_step_range``), and
    on at most STEM_STEP_SHARE of the outputs differs at all."""
    x, wt, b = _stem_inputs(n, h, w, cuda)
    got = st.stem_cuda(x, wt, b)
    torch.cuda.synchronize()
    hp, wp = st.out_size(st.out_size(h)), st.out_size(st.out_size(w))
    assert got.shape == (n, hp, wp, 64)
    for conv, plain in ((st.stem_conv_reference, st.stem_reference),
                        (st.stem_conv_ordered, st.stem_ordered)):
        lo, hi = st.one_step_range(st.pool(conv(x, wt)), b)
        assert bool(((got >= lo) & (got <= hi)).all()), plain.__name__
        share = (got != plain(x, wt, b)).float().mean().item()
        assert share <= STEM_STEP_SHARE, (plain.__name__, share)


@pytest.mark.cuda
def test_int8_stem_kernel_is_batch_invariant(cuda):
    """Crops 0, 59 and 127: each alone, and at its place in batches of 60 and
    128 crops, gives the same bits."""
    x, wt, b = _stem_inputs(128, 224, 224, cuda, seed=3)
    batches = {n: st.stem_cuda(x[:n], wt, b) for n in (60, 128)}
    for k in (0, 59, 127):
        one = st.stem_cuda(x[k:k + 1], wt, b)[0]
        for n, out in batches.items():
            if k < n:
                assert torch.equal(out[k], one), (k, n)


@pytest.mark.cuda
def test_int8_stem_kernel_rejects_bad_inputs(cuda):
    x, wt, b = _stem_inputs(1, 32, 32, cuda)
    with pytest.raises(ValueError, match="expected bfloat16"):
        st.stem_cuda(x, wt.float(), b)
    with pytest.raises(ValueError, match="expected \\(N, H, W, 3\\)"):
        st.stem_cuda(x[..., :2], wt, b)
    with pytest.raises(ValueError, match="expected float32 \\(64,\\)"):
        st.stem_cuda(x, wt, b.double())
    with pytest.raises(ValueError, match="expected float32 \\(64,\\)"):
        st.stem_cuda(x, wt, b[:32])
