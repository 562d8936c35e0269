"""The fused residual add + LayerNorm + cast (ops/add_layernorm.py,
csrc/add_layernorm.cu), with and without a LayerScale γ on the branch, and
the ViT forward built on it (models/vit.py).

On the CPU: the plain version is bit-equal to the three ops it replaces, the
ViT's forward is bit-equal to the loop it had before the norm points were
fused (kept below as the oracle), and what the benchmark's faults act on
(a block deleted, ``last_norm`` scaled, the state-dict keys) still acts. On
the card (``cuda``): the kernel against the plain version at HMR 2.0's
shape and at the tests' width, its launches a forward, and the wrapper's
checks. Imports neither JAX nor airpose_tpu, so on a machine with a card

  python -m pytest tests/test_torch_add_layernorm.py --noconftest -q
"""

import dataclasses

import pytest
import torch
from torch.nn import functional as F

from airpose_tpu_torch.models.vit import ViT, ViTConfig
from airpose_tpu_torch.ops import _build
from airpose_tpu_torch.ops import add_layernorm as aln

CFG = ViTConfig(img_size=(64, 48), width=64, depth=2, heads=4)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def operands(rows, width, branch_dtype, device="cpu", seed=0):
    """A residual stream, a branch and LayerNorm parameters off 1 and 0."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, width, generator=g) * 2 + 0.5
    branch = None if branch_dtype is None else torch.randn(rows, width, generator=g).to(
        branch_dtype)
    w = 1 + 0.1 * torch.randn(width, generator=g)
    b = 0.1 * torch.randn(width, generator=g)
    move = lambda t: None if t is None else t.to(device)  # noqa: E731
    return move(x), move(branch), move(w), move(b)


def gamma_of(width, device="cpu", seed=1):
    """A LayerScale γ at trained magnitudes, some channels negative."""
    g = torch.Generator().manual_seed(seed)
    return ((0.05 + torch.rand(width, generator=g)) * torch.randn(width, generator=g).sign()
            ).to(device)


def vit(dtype, depth=2, seed=0, cfg=CFG):
    model = ViT(dataclasses.replace(cfg, depth=depth), dtype,
                generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model.eval()


def crops(n=3, seed=4):
    return torch.rand(n, 64, 48, 3, generator=torch.Generator().manual_seed(seed))


def forward_before_fusion(model, x):
    """``ViT.forward`` as it was before the norm points were fused: each
    block adds its branches to the stream with ``+=`` and normalises with
    ``F.layer_norm`` and a cast, three passes a norm point."""
    def ln(h, norm):
        return F.layer_norm(h, norm.normalized_shape, norm.weight, norm.bias, norm.eps)

    pos = model.pos_embed[:, 1:] + model.pos_embed[:, :1]
    h = model.patch_embed(x.to(model.dtype)).float() + pos
    for blk in model.blocks:
        h += blk.attn(ln(h, blk.norm1).to(model.dtype))
        h += blk.mlp(ln(h, blk.norm2).to(model.dtype))
    return ln(h, model.last_norm)


@pytest.mark.parametrize("branch_dtype,out_dtype", [
    (BF16, BF16), (torch.float32, torch.float32), (None, BF16), (None, torch.float32),
    (BF16, torch.float32)])
def test_plain_version_is_the_three_ops(branch_dtype, out_dtype):
    x, branch, w, b = operands(37, 64, branch_dtype)
    want_x = x.clone()
    if branch is not None:
        want_x += branch
    want = F.layer_norm(want_x, (64,), w, b, 1e-6).to(out_dtype)
    got = aln.add_layernorm(x, branch, w, b, 1e-6, out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(x, want_x) and torch.equal(got, want)


@pytest.mark.parametrize("branch_dtype,out_dtype", [
    (BF16, BF16), (torch.float32, torch.float32), (BF16, torch.float32)])
def test_plain_version_with_gamma_is_the_scaled_add(branch_dtype, out_dtype):
    """With a LayerScale γ the plain version adds γ · branch (the product in
    float32, then the sum) and normalises; γ is ignored without a branch."""
    x, branch, w, b = operands(37, 64, branch_dtype)
    gamma = gamma_of(64)
    want_x = x.clone()
    want_x += gamma * branch.float()
    want = F.layer_norm(want_x, (64,), w, b, 1e-6).to(out_dtype)
    got = aln.add_layernorm(x, branch, w, b, 1e-6, out_dtype, gamma)
    assert torch.equal(x, want_x) and torch.equal(got, want)
    x2 = want_x.clone()
    assert torch.equal(aln.add_layernorm(x2, None, w, b, 1e-6, out_dtype, gamma),
                       aln.add_layernorm(want_x.clone(), None, w, b, 1e-6, out_dtype))
    assert torch.equal(x2, want_x)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_vit_forward_bit_equal_to_the_unfused_loop(dtype):
    model, x = vit(dtype), crops()
    with torch.no_grad():
        got = model(x)
        want = forward_before_fusion(model, x)
    assert got.dtype == torch.float32 and got.shape == (3, 12, 64)
    assert torch.equal(got, want)


def test_deleted_block_gives_the_shallower_vit():
    """The benchmark's ``skip_block`` fault deletes the last block: the loop
    reads the blocks at call time, so the forward is the depth − 1 one's."""
    model, shallow, x = vit(BF16), vit(BF16, depth=1), crops()
    shallow.load_state_dict({k: v for k, v in model.state_dict().items()
                             if not k.startswith("blocks.1.")})
    del model.blocks[-1]
    with torch.no_grad():
        got = model(x)
        assert torch.equal(got, shallow(x))
        assert torch.equal(got, forward_before_fusion(shallow, x))


def test_scaled_last_norm_scales_the_tokens():
    """The benchmark's ``scale_tokens`` fault scales ``last_norm``'s
    parameters in place; the tokens follow."""
    model, x = vit(BF16), crops()
    with torch.no_grad():
        before = model(x)
        for p in model.last_norm.parameters():
            p.mul_(1.05)
        after = model(x)
    torch.testing.assert_close(after, 1.05 * before, rtol=1e-6, atol=1e-6)


def test_state_dict_keys_unchanged():
    keys = set(vit(torch.float32).state_dict())
    per_block = {"norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
                 "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
                 "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"}
    assert keys == ({"patch_embed.proj.weight", "patch_embed.proj.bias", "pos_embed",
                     "last_norm.weight", "last_norm.bias"}
                    | {f"blocks.{i}.{k}" for i in range(2) for k in per_block})


def test_cost_counts_each_byte_once():
    x = torch.empty(24576, 1280)
    assert aln.add_layernorm_cost(x, x.to(BF16), BF16) == 24576 * 1280 * 12  # 377.5 MB
    assert aln.add_layernorm_cost(x, None, torch.float32) == 24576 * 1280 * 8


@pytest.mark.parametrize("case", ["width", "not_contiguous", "cpu", "dtype", "out_dtype"])
def test_kernel_wrapper_rejects(case):
    """The input checks come before any device is touched."""
    x, branch, w, b = operands(8, 64, BF16)
    out = BF16
    if case == "width":
        x, branch, w, b = operands(8, 60, BF16)
    elif case == "not_contiguous":
        x = torch.randn(64, 8).t()
    elif case == "dtype":
        x = x.double()
    elif case == "out_dtype":
        out = torch.float16
    with pytest.raises(ValueError):
        aln.add_layernorm_cuda(x, branch, w, b, 1e-6, out)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def bf16_steps(a, b):
    """Per value, how many bf16 steps apart ``a`` and ``b`` are."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", [(24576, 1280), (300, 64)])
@pytest.mark.parametrize("branch_dtype,out_dtype", [
    (BF16, BF16), (None, BF16), (BF16, torch.float32), (torch.float32, torch.float32)])
def test_kernel_matches_plain_version(cuda, rows, width, branch_dtype, out_dtype):
    x, branch, w, b = operands(rows, width, branch_dtype, cuda, seed=rows)
    want_x = x.clone()
    want = aln.add_layernorm_reference(want_x, branch, w, b, 1e-6, out_dtype)
    before = _build.counts["add_layernorm"]
    got = aln.add_layernorm(x, branch, w, b, 1e-6, out_dtype)
    torch.cuda.synchronize()
    assert _build.counts["add_layernorm"] == before + 1
    assert torch.equal(x, want_x)
    # the f32 rows differ by the order of the statistics' sums, within 2e-6 of
    # the largest output; rounded to bf16 that is one step, except on outputs
    # near 0, where the same small difference spans several steps
    near = (got.float() - want.float()).abs() <= 2e-6 * float(want.abs().max())
    if out_dtype == BF16:
        steps = bf16_steps(got, want)
        assert bool(((steps <= 1) | near).all())
        assert float((steps > 0).float().mean()) < 1e-3
    else:
        assert bool(near.all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", [(16 * 4097, 1024), (300, 64)])
@pytest.mark.parametrize("branch_dtype,out_dtype", [
    (BF16, BF16), (BF16, torch.float32), (torch.float32, torch.float32)])
def test_kernel_with_gamma_matches_plain_version(cuda, rows, width, branch_dtype, out_dtype):
    """DINOv2's LayerScale in the kernel, at Multi-HMR's rows (16 frames of
    4,097 tokens, 1,024 wide): the stream bit-equal to ``x += γ · branch``,
    the output as close as without γ."""
    x, branch, w, b = operands(rows, width, branch_dtype, cuda, seed=rows + 1)
    gamma = gamma_of(width, cuda)
    want_x = x.clone()
    want = aln.add_layernorm_reference(want_x, branch, w, b, 1e-6, out_dtype, gamma)
    before = _build.counts["add_layernorm"]
    got = aln.add_layernorm(x, branch, w, b, 1e-6, out_dtype, gamma)
    torch.cuda.synchronize()
    assert _build.counts["add_layernorm"] == before + 1
    assert torch.equal(x, want_x)
    near = (got.float() - want.float()).abs() <= 2e-6 * float(want.abs().max())
    if out_dtype == BF16:
        steps = bf16_steps(got, want)
        assert bool(((steps <= 1) | near).all())
        assert float((steps > 0).float().mean()) < 1e-3
    else:
        assert bool(near.all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_vit_on_the_card_launches_each_norm_point_once(cuda, dtype):
    model, x = vit(dtype).to(cuda), crops().to(cuda)
    before = _build.counts["add_layernorm"]
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        assert _build.counts["add_layernorm"] - before == 2 * CFG.depth + 1
        want = forward_before_fusion(model, x)
    assert got.dtype == torch.float32
    assert float((got - want).norm() / want.norm()) < (1e-2 if dtype == BF16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["width", "not_contiguous", "devices", "grad"])
def test_kernel_wrapper_rejects_on_the_card(cuda, case):
    x, branch, w, b = operands(8, 64, BF16, cuda)
    if case == "width":
        x, branch, w, b = operands(8, 60, BF16, cuda)
    elif case == "not_contiguous":
        x = torch.randn(64, 8, device=cuda).t()
    elif case == "devices":
        w = w.cpu()
    with pytest.raises(RuntimeError if case == "grad" else ValueError):
        if case == "grad":
            aln.add_layernorm(x, branch, w.requires_grad_(), b, 1e-6, BF16)
        else:
            aln.add_layernorm(x, branch, w, b, 1e-6, BF16)
