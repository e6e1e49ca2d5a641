"""The unique-read and GEMM microbenchmarks of the port
(``hydragen_torch/scripts/ubench_unique.py``, ``ubench_gemm.py``) and the
one-layer decode read they reach (``ops/decode.py:decode_attention_bshd``,
``chunk_kv_scales``, ``unchunk_kv_scales``), against the JAX package on the
CPU, every input made with numpy from a seed.

- ``chunk_kv_scales`` / ``unchunk_kv_scales`` equal JAX's bit for bit at
  every chunk width, and round-trip.
- ``decode_attention_bshd`` (its plain version here), with and without the
  own token and the shared partial, on ``[b, s, hkv]`` or flat scales: within
  ``TOL`` of JAX's plain reference composed as its kernel's function
  (``ops/reference.attention_bhsd(kv_bshd=True)``, the own token's column and
  ``combine_lse_with_stats``), fp32; and within the loose bound of
  ``tests/test_torch_ops.py`` of JAX's ``decode_attention_bshd`` in Pallas
  interpret mode (its kernel quantizes q and p to s8 for its matrix unit,
  which the port's exact path does not).
- The scripts' arms against the JAX functions the JAX scripts' arms call,
  at tiny shapes (fp32 operands where the arm takes them): ``ubench_gemm``'s
  bf16, dq, w8a8 (the Pallas kernel in interpret mode), w4a8 and dq4, and
  ``ubench_unique``'s plain reads at both widths and K3's two arms; then
  each script's ``main`` with ``--device cpu``: its rows and printed fields,
  each s8 arm within ``GEMM_TOL`` of its f32 oracle, K3's arms equal to the
  plain reads (the CPU runs their plain versions), a shape K1 or K6 does
  not take skipped with the reason.
"""

import contextlib
import io
import math

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU platform before jax)

import jax.numpy as jnp
import torch

from hydragen_tpu.ops import combine as jcombine
from hydragen_tpu.ops import decode as jdecode
from hydragen_tpu.ops import reference as jref

from hydragen_torch.ops import decode as tdecode
from hydragen_torch.scripts import ubench_gemm, ubench_unique

torch.set_num_threads(1)

TOL = 1e-5  # fp32 against JAX's plain reference; the frameworks sum in other orders
INTERPRET_RMS = 2e-2  # test_torch_ops.py's bound on the TPU kernel's s8 noise
GEMM_TOL = 1e-2  # an s8 arm's bf16 output against its f32 oracle (bf16: 2^-8)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def J(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("c", [1, 2, 4])
def test_chunk_kv_scales_match_jax_and_round_trip(c):
    rng = np.random.RandomState(20)
    sc = rng.rand(3, 5, 7, 4).astype(np.float32)  # [..., s, hkv]
    mine = tdecode.chunk_kv_scales(T(sc), c)
    theirs = np.asarray(jdecode.chunk_kv_scales(J(sc), c))
    assert mine.shape == theirs.shape == (3, 5, 4 // c, 7 * c)
    np.testing.assert_array_equal(mine.numpy(), theirs)
    back = tdecode.unchunk_kv_scales(mine, c)
    np.testing.assert_array_equal(back.numpy(), sc)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jdecode.unchunk_kv_scales(J(theirs), c)))


def _bshd_inputs(rng, b=3, s=16, hkv=2, hq=4, d=128, lens=(16, 0, 9)):
    k = rng.randint(-127, 128, (b, s, hkv, d)).astype(np.int8)
    v = rng.randint(-127, 128, (b, s, hkv, d)).astype(np.int8)
    ks = (rng.rand(b, s, hkv) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.rand(b, s, hkv) * 0.02 + 1e-3).astype(np.float32)
    q = rng.randn(b, hq, 1, d).astype(np.float32)
    k1 = rng.randn(b, hkv, 1, d).astype(np.float32)
    v1 = rng.randn(b, hkv, 1, d).astype(np.float32)
    o_sh = rng.randn(b, hq, 1, d).astype(np.float32)
    lse_sh = (rng.randn(b, hq, 1) * 2).astype(np.float32)
    return k, v, ks, vs, q, (k1, v1), (o_sh, lse_sh), np.asarray(lens, np.int32)


def _jax_oracle(q, k, v, ks, vs, lens, own, shared):
    """JAX's plain reference of the decode read: the cache's partial, the
    own token's column (out v, lse q.k / sqrt(d)), the shared partial, merged
    by LSE."""
    b, hq, _, d = q.shape
    hkv = k.shape[2]
    outs, lses = [], []
    if shared is not None:
        outs.append(J(shared[0]))
        lses.append(J(shared[1]))
    uo, ul = jref.attention_bhsd(J(q), J(k), J(v), kv_seq_lens=J(lens), k_scale=J(ks),
                                 v_scale=J(vs), kv_bshd=True)
    outs.append(uo)
    lses.append(ul)
    if own is not None:
        g = hq // hkv
        qg = J(q).reshape(b, hkv, g, 1, d)
        lses.append((jnp.einsum("bkgmd,bkmd->bkgm", qg, J(own[0])) / math.sqrt(d))
                    .reshape(b, hq, 1))
        outs.append(jnp.broadcast_to(J(own[1])[:, :, None], (b, hkv, g, 1, d))
                    .reshape(b, hq, 1, d))
    if len(outs) == 1:
        return uo, ul
    return jcombine.combine_lse_with_stats(outs, lses)


@pytest.mark.parametrize("chunked", [False, True], ids=["bsh-scales", "flat-scales"])
@pytest.mark.parametrize("own,shared", [(False, False), (True, False), (True, True)])
def test_decode_attention_bshd_matches_jax_reference(own, shared, chunked):
    rng = np.random.RandomState(21)
    k, v, ks, vs, q, own_kv, sh, lens = _bshd_inputs(rng)
    hkv = k.shape[2]
    kc, vc = ((tdecode.chunk_kv_scales(T(x), hkv) if chunked else T(x)) for x in (ks, vs))
    to, tl = tdecode.decode_attention_bshd(
        T(q), T(k), T(v), kv_seq_lens=T(lens), k_scale=kc, v_scale=vc, scales_chunked=chunked,
        own_kv=tuple(map(T, own_kv)) if own else None,
        shared_partial=tuple(map(T, sh)) if shared else None)
    jo, jl = _jax_oracle(q, k, v, ks, vs, lens, own_kv if own else None, sh if shared else None)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    if not (own or shared):
        assert np.isneginf(tl.numpy()[1]).all()  # the row with no history


def test_decode_attention_bshd_matches_jax_kernel_in_interpret_mode():
    rng = np.random.RandomState(22)
    k, v, ks, vs, q, own_kv, sh, lens = _bshd_inputs(rng, b=2, lens=(16, 7))
    hkv = k.shape[2]
    to, tl = tdecode.decode_attention_bshd(
        T(q), T(k), T(v), kv_seq_lens=T(lens), k_scale=tdecode.chunk_kv_scales(T(ks), hkv),
        v_scale=tdecode.chunk_kv_scales(T(vs), hkv), scales_chunked=True,
        own_kv=tuple(map(T, own_kv)), shared_partial=tuple(map(T, sh)))
    jo, jl = jdecode.decode_attention_bshd(
        J(q), J(k), J(v), kv_seq_lens=J(lens), k_scale=jdecode.chunk_kv_scales(J(ks), hkv),
        v_scale=jdecode.chunk_kv_scales(J(vs), hkv), scales_chunked=True,
        own_kv=tuple(map(J, own_kv)), shared_partial=tuple(map(J, sh)), interpret=True)
    jo = np.asarray(jo)
    rms = np.sqrt(np.mean((to.numpy() - jo) ** 2)) / np.sqrt(np.mean(jo ** 2))
    assert rms < INTERPRET_RMS, rms
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=INTERPRET_RMS)


# --- ubench_unique -------------------------------------------------------------


def test_ubench_unique_arms_match_jax():
    """Each arm's output against the JAX function its JAX arm calls (the
    plain reads at both widths; JAX's decode read for K3's two arms, on the
    same chunked scales, in interpret mode within the kernel's s8 noise)."""
    rng = np.random.RandomState(23)
    b, hq, hkv, s, d = 2, 4, 2, 16, 128
    q = rng.randn(b, hq, 1, d).astype(np.float32)
    k8 = rng.randint(-127, 128, (b, s, hkv, d)).astype(np.int8)
    v8 = rng.randint(-127, 128, (b, s, hkv, d)).astype(np.int8)
    ks = (rng.rand(b, s, hkv) * 0.02).astype(np.float32)
    vs = (rng.rand(b, s, hkv) * 0.02).astype(np.float32)
    lens = np.full((b,), s, np.int32)
    ops = ubench_unique.arms(T(q), T(k8), T(v8), T(ks), T(vs), T(lens))
    out = {name: op(*args) for name, (_, op, args) in ops.items()}

    def pack_s(x):  # the JAX script's token-planar pack
        lo = x[:, : s // 2].astype(jnp.int32)
        hi = x[:, s // 2:].astype(jnp.int32)
        return ((hi << 4) | (lo & 0xF)).astype(jnp.int8)

    pk, pv = pack_s(jnp.clip(J(k8), -7, 7)), pack_s(jnp.clip(J(v8), -7, 7))
    np.testing.assert_array_equal(ops["kv4"][2][1].numpy(), np.asarray(pk))
    kw = dict(kv_seq_lens=J(lens), k_scale=J(ks), v_scale=J(vs), kv_bshd=True)
    want = {"plain": jref.attention_bhsd(J(q), J(k8), J(v8), **kw),
            "plain4": jref.attention_bhsd(J(q), pk, pv, kv_bits=4, **kw)}
    for name, (jo, jl) in want.items():
        np.testing.assert_allclose(out[name][0].numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out[name][1].numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    ksc, vsc = jdecode.chunk_kv_scales(J(ks), hkv), jdecode.chunk_kv_scales(J(vs), hkv)
    kernels = {
        "k3": jdecode.decode_attention_bshd(J(q), J(k8), J(v8), kv_seq_lens=J(lens),
                                            k_scale=ksc, v_scale=vsc, scales_chunked=True,
                                            interpret=True),
        "kv4": jdecode.decode_attention_cached(
            jnp.int32(0), J(q), pk[None], pv[None], kv_seq_lens=J(lens),
            k_scale_all=ksc.reshape(1, b, s * hkv), v_scale_all=vsc.reshape(1, b, s * hkv),
            kv_bits=4, interpret=True),
    }
    for name, (jo, jl) in kernels.items():
        jo = np.asarray(jo)
        rms = np.sqrt(np.mean((out[name][0].numpy() - jo) ** 2)) / np.sqrt(np.mean(jo ** 2))
        assert rms < INTERPRET_RMS, (name, rms)
        np.testing.assert_allclose(out[name][1].numpy(), np.asarray(jl), atol=INTERPRET_RMS)


def test_ubench_unique_main_on_the_cpu():
    argv = ["--device", "cpu", "--b", "4", "--hq", "8", "--hkv", "2", "--s", "16",
            "--iters", "2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ubench_unique.main(argv)
    text = out.getvalue()
    assert list(res) == list(ubench_unique.ARMS)
    for name, row in res.items():
        assert row["ms"] > 0 and row["bound_ms"] > 0 and row["bound_by"] == "bytes", name
        assert f"{name:7s} int" in text
    for name in ("k3", "kv4"):  # the plain versions on the CPU: the plain reads
        assert res[name]["dout"] == 0.0 and res[name]["dlse"] == 0.0 and res[name]["rel"] == 0.0
        assert "dout=0.0000 dlse=0.00000" in text
    assert text.startswith("card: cpu\n")
    with pytest.raises(SystemExit, match="must be even"):
        ubench_unique.main(argv[:-4] + ["--s", "15"])


# --- ubench_gemm ---------------------------------------------------------------


def test_ubench_gemm_arms_match_jax():
    """Each arm's output against the JAX script's arm on the same numpy
    operands: the bf16 and dq einsums, ``w8a8_matmul`` and ``w4a8_matmul``
    in interpret mode, and the int4 dequantization's einsum: equal up to a
    bf16 rounding of the output (2^-8 relative to the largest)."""
    from hydragen_tpu.ops import gemm as jgemm
    from hydragen_tpu.ops.quant import Quantized4Tensor as J4
    from hydragen_tpu.ops.quant import dequantize4 as jdq4

    rng = np.random.RandomState(24)
    M, K, N = 16, 256, 128
    x = rng.randn(M, K).astype(np.float32)
    w8 = rng.randint(-127, 128, (N, K)).astype(np.int8)
    ws = (rng.rand(N) * 0.02).astype(np.float32)
    qp = rng.randint(-128, 128, (N, K // 2)).astype(np.int8)
    gs = (rng.rand(K // 128, N) * 0.02).astype(np.float32)
    xb = T(x).to(torch.bfloat16)
    wsb = T(ws).to(torch.bfloat16)
    from hydragen_torch.ops.quant import Quantized4Tensor, QuantizedTensor

    ops = ubench_gemm.arms(xb, QuantizedTensor(T(w8), wsb), T(w8).to(torch.bfloat16)
                           * wsb[:, None], Quantized4Tensor(T(qp), T(gs).to(torch.bfloat16)))
    got = {name: op(*args).float().numpy() for name, (op, args, *_) in ops.items()}
    jx, jws = J(x).astype(jnp.bfloat16), J(ws).astype(jnp.bfloat16)
    jw4 = J4(qp=J(qp), gscale=J(gs).astype(jnp.bfloat16))
    wbf = J(w8).astype(jnp.bfloat16) * jws[:, None]
    a_q, a_s = jgemm.quantize_rows(jx)
    want = {
        "bf16": jnp.einsum("mk,nk->mn", jx, wbf, preferred_element_type=jnp.float32),
        "dq": jnp.einsum("mk,nk->mn", jx, J(w8).astype(jnp.bfloat16) * jws[:, None],
                         preferred_element_type=jnp.float32),
        "w8a8": jgemm.w8a8_matmul(a_q, a_s, J(w8), jws, block_n=128, block_k=256,
                                  interpret=True),
        "w4a8": jgemm.w4a8_matmul(a_q, a_s, jw4.qp, jw4.gscale, block_n=128, block_kp=128,
                                  interpret=True),
        "dq4": jnp.einsum("mk,kn->mn", jx, jdq4(jw4), preferred_element_type=jnp.float32),
    }
    assert list(got) == list(ubench_gemm.ARMS)
    for name, w in want.items():
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(got[name] - w).max() / np.abs(w).max()
        assert err <= 2 ** -8, (name, err)


def test_ubench_gemm_main_on_the_cpu(monkeypatch):
    """Tiny shapes under the script's own names: a row an arm with its time,
    bound and distance from its f32 oracle; a shape neither K1 (K not a
    multiple of 16) nor K6 (group 100) takes is skipped with the reason."""
    monkeypatch.setitem(ubench_gemm.SHAPES, "tiny", (256, 192))
    monkeypatch.setitem(ubench_gemm.SHAPES, "odd", (200, 64))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = ubench_gemm.main(["--device", "cpu", "--m", "8", "--shapes", "tiny,odd",
                                 "--iters", "2"])
    text = out.getvalue()
    tiny = {r["arm"]: r for r in rows if r["shape"] == "tiny"}
    odd = {r["arm"]: r for r in rows if r["shape"] == "odd"}
    assert list(tiny) == list(ubench_gemm.ARMS)
    assert sorted(odd) == ["bf16", "dq", "dq4"]
    for r in rows:
        assert r["ms"] > 0 and r["bound_ms"] > 0 and r["rel_err"] <= GEMM_TOL, r
    assert tiny["w8a8"]["bound_by"] == "bytes" and (tiny["w8a8"]["M"], tiny["w8a8"]["K"],
                                                    tiny["w8a8"]["N"]) == (8, 256, 192)
    assert "w8a8 : skipped (K1 does not take N=64, K=200" in text
    assert "w4a8 : skipped (K6 does not take N=64, K=200 at group 100" in text
    assert text.startswith("card: cpu\n") and "== tiny: M=8 K=256 N=192" in text
