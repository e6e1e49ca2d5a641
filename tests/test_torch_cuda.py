"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present (decided in
a fixture, at run time). On the card, run them with
``python -m pytest tests/test_torch_cuda.py -m gpu``. Shapes are small and
ragged, to reach every tail of the kernels. Tolerances are for bf16: the
kernels round P to bf16 before the second product (flash) and the outputs
to bf16, where the plain versions compute in fp32 from the same bf16 inputs.
"""

import pytest
import torch

from hydragen_torch.ops import cuda_lib
from hydragen_torch.ops import decode as tdecode
from hydragen_torch.ops import flash as tflash
from hydragen_torch.ops import gemm as tgemm

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _gen(seed=0):
    return torch.Generator(device="cuda").manual_seed(seed)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("M,N,K", [(5, 130, 96), (256, 512, 4096), (70, 11264, 256)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w8a8_kernel_matches_plain(dev, M, N, K, out_dtype):
    g = _gen(1)
    a = torch.randn(M, K, device=dev, generator=g)
    a_q, a_s = tgemm.quantize_rows(a)
    w = torch.randint(-127, 128, (3, N, K), dtype=torch.int8, device=dev, generator=g)
    ws = (torch.rand(3, N, device=dev, generator=g) * 0.01 + 1e-3).to(torch.bfloat16)
    before = cuda_lib.LAUNCHES["w8a8_matmul_cached"]
    out = tgemm.w8a8_matmul_cached(2, a_q, a_s, w, ws, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["w8a8_matmul_cached"] == before + 1
    ref = tgemm.w8a8_cached_plain(2, a_q, a_s, w, ws, out_dtype=torch.float32)
    tol = 1e-2 if out_dtype == torch.bfloat16 else 1e-5
    assert _rel(out, ref) < tol


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,int8,lens", [
    (True, False, None), (False, True, [70, 0]), (True, True, [100, 37]),
    (False, False, [1, 100]),
])
def test_flash_kernel_matches_plain(dev, d, causal, int8, lens):
    g = _gen(2)
    b, hq, hkv, m, s = 2, 4, 2, 67 if causal else 9, 100
    q = torch.randn(b, hq, m, d, device=dev, generator=g).to(torch.bfloat16)
    if int8:
        k = torch.randint(-127, 128, (b, hkv, s, d), dtype=torch.int8, device=dev, generator=g)
        v = torch.randint(-127, 128, (b, hkv, s, d), dtype=torch.int8, device=dev, generator=g)
        ks = torch.rand(b, hkv, s, device=dev, generator=g) * 0.02 + 1e-3
        vs = torch.rand(b, hkv, s, device=dev, generator=g) * 0.02 + 1e-3
    else:
        k = torch.randn(b, hkv, s, d, device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn(b, hkv, s, d, device=dev, generator=g).to(torch.bfloat16)
        ks = vs = None
    kw = dict(causal=causal, k_scale=ks, v_scale=vs,
              kv_seq_lens=None if lens is None else torch.tensor(lens, device=dev))
    o, l = tflash.flash_attention_bhsd(q, k, v, **kw)
    po, pl = tflash.flash_attention_bhsd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)


def test_flash_cached_kernel_matches_plain(dev):
    g = _gen(3)
    L, SB, hkv, S, d, b, hq, m = 3, 3, 2, 150, 128, 2, 4, 33
    k = torch.randint(-127, 128, (L, SB, hkv, S, d), dtype=torch.int8, device=dev, generator=g)
    v = torch.randint(-127, 128, (L, SB, hkv, S, d), dtype=torch.int8, device=dev, generator=g)
    ks = torch.rand(L, SB, hkv, S, device=dev, generator=g) * 0.02 + 1e-3
    vs = torch.rand(L, SB, hkv, S, device=dev, generator=g) * 0.02 + 1e-3
    q = torch.randn(b, hq, m, d, device=dev, generator=g).to(torch.bfloat16)
    lens = torch.tensor([150, 77], device=dev, dtype=torch.int32)
    for layer in (0, 2):
        kw = dict(kv_seq_lens=lens, k_scale_all=ks, v_scale_all=vs)
        o, l = tflash.flash_attention_cached_bhsd(layer, q, k, v, **kw)
        po, pl = tflash.flash_attention_cached_plain(layer, q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("own,shared", [(False, False), (True, True)])
def test_decode_kernel_matches_plain(dev, group, own, shared):
    g = _gen(4)
    L, B, S, hkv, d, b = 2, 6, 40, 2, 128, 5
    hq = hkv * group
    k = torch.randint(-127, 128, (L, B, S, hkv, d), dtype=torch.int8, device=dev, generator=g)
    v = torch.randint(-127, 128, (L, B, S, hkv, d), dtype=torch.int8, device=dev, generator=g)
    ks = torch.rand(L, B, S * hkv, device=dev, generator=g) * 0.02 + 1e-3
    vs = torch.rand(L, B, S * hkv, device=dev, generator=g) * 0.02 + 1e-3
    q = torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16)
    lens = torch.tensor([40, 0, 13, 1, 99], device=dev, dtype=torch.int32)
    kw = dict(kv_seq_lens=lens, k_scale_all=ks, v_scale_all=vs)
    if own:
        kw["own_kv"] = tuple(torch.randn(b, hkv, 1, d, device=dev, generator=g)
                             .to(torch.bfloat16) for _ in range(2))
    if shared:
        kw["shared_partial"] = (
            torch.randn(b, hq, 1, d, device=dev, generator=g).to(torch.bfloat16),
            torch.randn(b, hq, 1, device=dev, generator=g) * 2,
        )
    o, l = tdecode.decode_attention_cached(1, q, k, v, **kw)
    po, pl = tdecode.decode_attention_cached_plain(1, q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)


def test_engine_kernel_path_matches_plain_path(dev):
    """A small bf16 w8a8 + int8-KV engine: the kernel path (default) and the
    plain path (impl="torch") give close logits along one forced token
    stream, and the kernel path launches every kernel. The unique cache is
    BSHD, the layout the decode kernel reads (at 7B widths it is the
    default)."""
    from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
    from hydragen_torch.models.llama import init_params

    cfg = ModelConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4)
    params = init_params(cfg, _gen(5), quantized="w8a8", device=dev)
    prompt = torch.randint(1, 512, (1, 200), generator=_gen(6), device=dev)
    forced = torch.randint(1, 512, (8, 3), generator=_gen(7), device=dev)
    logits = {}
    for impl in ("kernel", "torch"):
        e = HydragenLlama(cfg, params, impl=impl, quantization="w8a8")
        e.setup_caches(8, 16, [1], [256], kv_quant="int8", unique_bshd=True)
        cuda_lib.reset_launches()
        _, lg = e.generate(input_ids=[prompt], num_return_sequences=8, max_new_tokens=3,
                           temperature=0.0, shared_cache_op=SharedCacheOp.WIPE,
                           return_logits=True, token_overrides=forced)
        logits[impl] = lg
        counts = dict(cuda_lib.LAUNCHES)
        if impl == "kernel":
            assert all(c > 0 for c in counts.values()), counts
        else:
            assert not any(counts.values()), counts
    for a, b in zip(logits["kernel"], logits["torch"]):
        assert _rel(a, b) < 5e-2
        assert torch.isfinite(a).all()


@pytest.mark.parametrize("case", ["fp32", "head_dim_32"])
def test_engine_kernel_path_raises_where_a_kernel_does_not_take(dev, case):
    """On the card, impl="kernel" never falls back to a plain version: an
    fp32 model (the flash kernel reads bf16 queries) or a head size the
    kernels lack raises in the flash kernel's wrapper at the first prefill."""
    from hydragen_torch import HydragenLlama, ModelConfig, SharedCacheOp
    from hydragen_torch.models.llama import init_params

    cfg = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2)
    if case == "fp32":
        cfg["dtype"] = "float32"
    else:
        cfg.update(num_attention_heads=8, num_key_value_heads=8)
    cfg = ModelConfig(**cfg)
    e = HydragenLlama(cfg, init_params(cfg, _gen(8), device=dev), impl="kernel")
    e.setup_caches(4, 8, [1], [32])
    prompt = torch.randint(1, 256, (1, 20), generator=_gen(9), device=dev)
    with pytest.raises(ValueError, match="flash kernel"):
        e.generate(input_ids=[prompt], num_return_sequences=4, max_new_tokens=2,
                   temperature=0.0, shared_cache_op=SharedCacheOp.WIPE)


def test_w8a8_stacked_raises_on_a_shape_the_kernel_does_not_take(dev):
    """A w8a8 projection whose K the kernel does not take raises on the card
    instead of running weight-only dq."""
    from hydragen_torch.ops.quant import QuantizedTensor, qmatmul_stacked

    g = _gen(10)
    w = QuantizedTensor(
        torch.randint(-127, 128, (2, 64, 40), dtype=torch.int8, device=dev, generator=g),
        torch.full((2, 64), 1e-2, dtype=torch.bfloat16, device=dev),
    )
    x = torch.randn(1, 3, 40, device=dev, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="w8a8 kernel"):
        qmatmul_stacked(x, w, 1, "bth,hd->btd", impl="w8a8")


def test_timing_helpers_time_device_work(dev):
    from hydragen_torch.utils.timing import cuda_time_ms, timed

    x = torch.randn(1024, 1024, device=dev)
    assert cuda_time_ms(lambda: x @ x, iters=3, warmup=1) > 0
    times, warm = timed(lambda: x @ x, num_iters=3, num_warmup=2,
                        between_fn=lambda: x.zero_().add_(1))
    assert len(times) == 3 and len(warm) == 2 and min(times) > 0
