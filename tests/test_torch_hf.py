"""The port's HF loading (``hydragen_torch/models/hf.py``) against the JAX
package's (``hydragen_tpu/models/hf.py``) and against transformers, on the
CPU.

- The host quantizers equal ``_np_quantize`` / ``_np_quantize4`` bit for bit,
  on inputs where an f32 division by 127 and a product with its reciprocal
  differ.
- ``params_from_hf_state_dict`` equals the JAX function tensor by tensor for
  all five quantizations, with tied and untied heads and attention biases,
  from f32 and bf16 state dicts.
- ``config.json`` takes ``transformers.LlamaConfig``'s defaults.
- The reader: ``from_pretrained`` on ``save_pretrained`` output (one
  safetensors file, sharded safetensors, ``.bin``) equals ``from_hf_model``'s
  conversion, and ``chip_smoke.py``'s writer reads back with
  ``safetensors.torch.load_file``.
- The HF oracle: an engine from ``from_hf_model(dtype="float32")`` gives
  ``hf_model.generate``'s greedy tokens and scores on ``tests/test_e2e.py``'s
  topologies, within that file's bounds.
- w8a8 from disk: the port's ``from_pretrained(quantization="w8a8")`` against
  the JAX engine's (``HYDRAGEN_W8A8_INTERPRET=1``). Its widths are multiples
  of 128, which the JAX s8 GEMM needs (at 64 it would run weight-only). Its
  inputs are fixed by seed for the reason ``ROADMAP.md`` §3 gives: under
  w8a8 + int8 KV a last-bit difference in the float sums upstream of a
  per-row quantization can land one code apart at a half-code tie, in
  either package.
- ``disable_hierarchy``: ``tests/test_e2e.py``'s consistency test on the
  port, and the ablation against the JAX engine's.

Small models (2 layers, hidden 64) in fp32 unless stated.
"""

import dataclasses
import json

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU platform before jax)

import jax
import torch
import transformers

from hydragen_tpu.core.engine import HydragenLlama as JEngine
from hydragen_tpu.core.engine import SharedCacheOp as JOp
from hydragen_tpu.models import hf as jhf
from hydragen_tpu.models.config import ModelConfig as JConfig

import chip_smoke
from hydragen_torch import HydragenLlama as TEngine
from hydragen_torch import ModelConfig as TConfig
from hydragen_torch import SharedCacheOp as TOp
from hydragen_torch.models import hf as thf
from hydragen_torch.models.checkpoint import flatten
from hydragen_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

VOCAB = 128
QUANTIZATIONS = [None, "int8", "w8a8", "int4", "w4a8"]


def _hf_config(**kw):
    base = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
                rms_norm_eps=1e-5, tie_word_embeddings=False)
    return transformers.LlamaConfig(**dict(base, **kw))


def _hf_model(seed=0, **kw):
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(_hf_config(**kw)).eval()


@pytest.fixture(scope="module")
def hf_model():
    return _hf_model()


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _leaves(tree):
    """{dotted name: tensor} of a parameter dict, either package's (a JAX
    leaf to torch through numpy)."""
    return {k: v if torch.is_tensor(v) else params_from_numpy(np.asarray(v))
            for k, v in flatten(tree).items()}


def assert_params_equal(got, want):
    """Tensor by tensor: names, dtypes, shapes and bits."""
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
        assert torch.equal(got[k].contiguous(), want[k].contiguous()), k


# --- Host quantizers --------------------------------------------------------


def _weights(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape) * rng.rand(*shape[:-1], 1) * 3
    w[..., 0, :] = 0.0  # an all-zero channel takes the 1e-8 floor
    return torch.from_numpy(w.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(2, 48, 96), (3, 130, 512), (64, 11008)])
def test_host_quantizers_are_bit_equal_to_jax(shape, dtype):
    w = _weights(shape, dtype, seed=len(shape) + shape[-1])
    wf = w.float()
    amax = wf.abs().amax(-1).clamp(min=1e-8)
    # The inputs tell a true division by 127 from a product with its reciprocal.
    assert not torch.equal(amax / 127.0, amax * torch.tensor(1 / 127.0))
    w_in = np.swapaxes(wf.numpy(), -1, -2)  # JAX's [..., in, out], its f32 values
    j = jhf._np_quantize(w_in)
    t = thf._quantize_host(w)
    assert t.scale.dtype == torch.float32
    assert np.array_equal(t.q.numpy(), np.asarray(j.q))
    assert np.array_equal(t.scale.numpy(), np.asarray(j.scale))
    j4 = jhf._np_quantize4(w_in)
    t4 = thf._quantize4_host(w)
    assert t4.gscale.dtype == torch.bfloat16
    assert np.array_equal(t4.qp.numpy(), np.asarray(j4.qp))
    assert torch.equal(t4.gscale, params_from_numpy(np.asarray(j4.gscale)))


# --- The transplant -----------------------------------------------------------


@pytest.fixture(scope="module")
def state_dicts():
    """HF state dicts: untied head with attention biases, and tied head; each
    in f32 and bf16."""
    out = {}
    for name, kw in (("untied_bias", dict(attention_bias=True)),
                     ("tied", dict(tie_word_embeddings=True))):
        m = _hf_model(seed=3, **kw)
        with torch.no_grad():  # biases and norms off their zeros and ones
            for p in m.parameters():
                if p.ndim == 1:
                    p.add_(torch.randn_like(p) * 0.1)
        sd = {k: v.clone() for k, v in m.state_dict().items()}
        if m.config.tie_word_embeddings:
            sd.pop("lm_head.weight", None)
        out[name, "float32"] = (m.config, sd)
        out[name, "bfloat16"] = (m.config, {k: v.to(torch.bfloat16) for k, v in sd.items()})
    return out


@pytest.mark.parametrize("quantization", QUANTIZATIONS, ids=str)
@pytest.mark.parametrize("source", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", ["untied_bias", "tied"])
def test_transplant_matches_jax(state_dicts, quantization, source, head):
    hf_cfg, sd = state_dicts[head, source]
    tcfg = TConfig.from_hf_config(hf_cfg, dtype="bfloat16")
    jcfg = JConfig.from_hf_config(hf_cfg, dtype="bfloat16")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    got = thf.params_from_hf_state_dict(sd, tcfg, quantization)
    want = jhf.params_from_hf_state_dict(sd, jcfg, quantization=quantization)
    assert_params_equal(got, want)
    if quantization in ("int8", "w8a8") and head == "untied_bias":
        assert got["lm_head"].scale.dtype == torch.float32
        assert got["layers"]["gate"].q.shape[1] == hf_cfg.intermediate_size  # not padded


# --- config.json --------------------------------------------------------------


LLAMA31 = {
    "model_type": "llama", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "vocab_size": 128, "rope_theta": 500000.0, "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
}
CONFIGS = {"minimal": {"model_type": "llama"}, "llama-3.1": LLAMA31,
           "linear": {"model_type": "llama", "rope_scaling": {"type": "linear", "factor": 2.0}}}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_json_takes_llama_config_defaults(tmp_path, name):
    raw = CONFIGS[name]
    (tmp_path / "config.json").write_text(json.dumps(raw))
    got = thf.config_from_json(tmp_path / "config.json", dtype="float32")
    want = TConfig.from_hf_config(transformers.LlamaConfig(**raw), dtype="float32")
    assert got == want
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JConfig.from_hf_config(transformers.LlamaConfig(**raw), dtype="float32"))


def test_config_json_refuses_other_models(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "mistral"}))
    with pytest.raises(ValueError, match="only 'llama'"):
        thf.config_from_json(tmp_path / "config.json")
    with pytest.raises(FileNotFoundError, match="local checkpoint directory"):
        thf.from_pretrained(tmp_path / "missing")


# --- The reader ---------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory, hf_model):
    root = tmp_path_factory.mktemp("hf")
    dirs = {"safetensors": root / "single", "sharded": root / "sharded", "bin": root / "bin"}
    hf_model.save_pretrained(dirs["safetensors"], safe_serialization=True)
    hf_model.save_pretrained(dirs["sharded"], safe_serialization=True, max_shard_size="40KB")
    hf_model.save_pretrained(dirs["bin"], safe_serialization=False)
    return dirs


@pytest.mark.parametrize("layout", ["safetensors", "sharded", "bin"])
@pytest.mark.parametrize("quantization", [None, "w8a8"], ids=str)
def test_from_pretrained_reads_save_pretrained(hf_dirs, hf_model, layout, quantization):
    path = hf_dirs[layout]
    if layout == "sharded":
        assert (path / "model.safetensors.index.json").exists()
        assert len(list(path.glob("*.safetensors"))) > 1
    cfg, params = thf.from_pretrained(path, dtype="float32", quantization=quantization)
    cfg_m, params_m = thf.from_hf_model(hf_model, dtype="float32", quantization=quantization)
    assert cfg == cfg_m
    assert_params_equal(params, params_m)
    assert thf.checkpoint_bytes(path) == sum(f.stat().st_size for f in path.iterdir()
                                             if f.suffix in (".safetensors", ".bin"))


def test_reader_refuses_a_dtype_it_does_not_take(tmp_path):
    from safetensors.torch import save_file

    save_file({"a": torch.zeros(3, dtype=torch.int64)}, str(tmp_path / "x.safetensors"))
    with pytest.raises(ValueError, match="dtype I64"):
        thf.read_safetensors(tmp_path / "x.safetensors")


def test_chip_smoke_writer_reads_back(tmp_path, hf_model):
    """chip_smoke.py's writer: every shard reads back with safetensors'
    own reader, the index names every tensor, and from_pretrained gives
    from_hf_model's conversion."""
    from safetensors.torch import load_file

    cfg = TConfig.from_hf_config(hf_model.config, dtype="bfloat16")
    state = {k: v.to(torch.bfloat16) for k, v in hf_model.state_dict().items()}
    written = chip_smoke.write_hf_checkpoint(tmp_path, cfg, state, shards=3)
    files = sorted(tmp_path.glob("*.safetensors"))
    assert len(files) == 3 and written == sum(f.stat().st_size for f in files)
    back = {}
    for f in files:
        back.update(load_file(str(f)))
    assert sorted(back) == sorted(state)
    for k in state:
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], state[k]), k
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert sorted(index["weight_map"]) == sorted(state)
    got_cfg, got = thf.from_pretrained(tmp_path, dtype="bfloat16", quantization="w8a8")
    assert got_cfg == cfg
    assert_params_equal(got, thf.params_from_hf_state_dict(state, cfg, "w8a8"))


def test_from_pretrained_without_device_needs_cuda(hf_dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine.from_pretrained(hf_dirs["safetensors"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine.from_pretrained(hf_dirs["safetensors"], quantization="w8a8")


# --- The HF oracle -------------------------------------------------------------


def hf_reference_generate(hf_model, full_input_ids, max_new_tokens):
    with torch.no_grad():
        out = hf_model.generate(torch.tensor(np.asarray(full_input_ids)),
                                max_new_tokens=max_new_tokens, do_sample=False,
                                output_scores=True, return_dict_in_generate=True,
                                pad_token_id=0)
    return out.sequences[:, full_input_ids.shape[1]:].numpy(), [s.numpy() for s in out.scores]


def mean_rdiff(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return (2 * np.abs(a - b) / (np.abs(a) + np.abs(b) + 1e-9)).mean()


# tests/test_e2e.py's topologies: (level lengths, level batches, suffix batch, nrs)
CACHE_TOPOLOGIES = [
    ([6], [1], 1, 1),
    ([6], [1], 2, 1),
    ([6, 4], [1, 2], 2, 1),
    ([6], [1], 1, 2),
    ([6, 4], [1, 2], 2, 2),
]


@pytest.fixture(scope="module")
def engine(hf_model):
    return TEngine.from_hf_model(hf_model, dtype="float32", device="cpu")


@pytest.mark.parametrize("topology", CACHE_TOPOLOGIES,
                         ids=[str(i) for i in range(len(CACHE_TOPOLOGIES))])
def test_generate_matches_hf(hf_model, engine, topology):
    """``tests/test_e2e.py::test_generate_logit_parity`` on the port: the HF
    greedy stream forced, each step's scores within that test's bounds, and
    the greedy tokens equal."""
    level_lens, level_bs, suffix_bs, nrs = topology
    max_new = 8
    rng = np.random.RandomState(42)
    ids = [rng.randint(1, VOCAB, size=(bs, ln)).astype(np.int32)
           for ln, bs in zip(level_lens, level_bs)]
    suffix = rng.randint(1, VOCAB, size=(suffix_bs, 3)).astype(np.int32)
    ids.append(suffix)
    total_bs = suffix_bs * nrs
    full = np.stack([np.concatenate([arr[row // (suffix_bs // arr.shape[0])] for arr in ids])
                     for row in range(suffix_bs)])
    full = np.repeat(full, nrs, axis=0)
    ref_new_ids, ref_scores = hf_reference_generate(hf_model, full, max_new)
    engine.setup_caches(
        max_unique_batch_size=total_bs, max_unique_seq_length=suffix.shape[1] + max_new + 2,
        max_shared_batch_sizes=[a.shape[0] for a in ids] + [total_bs],
        max_shared_seq_lengths=[a.shape[1] + 1 for a in ids] + [4],
    )
    tokens, logits = engine.generate(
        input_ids=ids, num_return_sequences=nrs, max_new_tokens=max_new, temperature=0.0,
        return_logits=True, shared_cache_op=TOp.WIPE, token_overrides=ref_new_ids)
    assert len(logits) == max_new
    for step in range(max_new):
        got, want = _np(logits[step]), ref_scores[step]
        assert got.shape == want.shape
        assert mean_rdiff(got, want) < 5e-3, step
        np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_array_equal(_np(tokens), ref_new_ids)
    # And free-running greedy decoding gives HF's tokens as well.
    engine.setup_caches(total_bs, suffix.shape[1] + max_new + 2,
                        [a.shape[0] for a in ids] + [total_bs],
                        [a.shape[1] + 1 for a in ids] + [4])
    free = engine.generate(input_ids=ids, num_return_sequences=nrs, max_new_tokens=max_new,
                           temperature=0.0, shared_cache_op=TOp.WIPE)
    np.testing.assert_array_equal(_np(free), ref_new_ids)


# --- w8a8 from disk against the JAX package ----------------------------------


W8A8_HF = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=512,
               rms_norm_eps=1e-5, tie_word_embeddings=False)


@pytest.fixture(scope="module")
def w8a8_dir(tmp_path_factory):
    torch.manual_seed(5)
    m = transformers.LlamaForCausalLM(transformers.LlamaConfig(**W8A8_HF)).eval()
    path = tmp_path_factory.mktemp("w8a8")
    m.save_pretrained(path, safe_serialization=True)
    return path


def test_w8a8_from_pretrained_matches_jax(w8a8_dir, monkeypatch):
    """The port's ``from_pretrained(quantization="w8a8")`` against the JAX
    engine's on one checkpoint on disk (f32 scales, the MLP unpadded), w8a8
    + int8 KV: parameters bit-equal; then a greedy request and a forced
    stream (a prompt level, a level of 2 suffixes, 2 samples each, 6 tokens:
    7 forward passes), every pass held: greedy tokens equal, logits within
    1e-3 (``tests/test_torch_engine.py``'s bound). Each quantization of the
    port is held to its JAX counterpart; a code that differs must be a tie
    of the engines' float sums, and the port goes on from JAX's codes there
    (``tests/test_torch_ties.py``)."""
    from tests.test_torch_ties import Resolver, assert_resolved, jax_recorded, port_resolved

    monkeypatch.setenv("HYDRAGEN_W8A8_INTERPRET", "1")
    je = JEngine.from_pretrained(str(w8a8_dir), dtype="float32", quantization="w8a8")
    te = TEngine.from_pretrained(w8a8_dir, dtype="float32", quantization="w8a8", device="cpu")
    assert_params_equal(te.params, jax.tree.map(np.asarray, je.params))
    assert te.params["layers"]["down"].q.shape[-1] == W8A8_HF["intermediate_size"]
    assert te.params["layers"]["wq"].scale.dtype == torch.float32
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, 256, (1, 10)).astype(np.int32)
    suffix = rng.randint(1, 256, (2, 5)).astype(np.int32)
    overrides = rng.randint(1, 256, (4, 6)).astype(np.int32)
    for e in (je, te):
        e.setup_caches(4, 16, [1, 2], [16, 8], kv_quant="int8", unique_bshd=True)
    kw = dict(input_ids=[prompt, suffix], num_return_sequences=2, max_new_tokens=6,
              temperature=0.0, return_logits=True)
    runs = (("greedy", {}), ("forced", dict(token_overrides=overrides)))
    records = []
    with jax_recorded(records):
        jax_out = [je.generate(shared_cache_op=JOp.WIPE, **kw, **extra) for _, extra in runs]
    with port_resolved(Resolver(records)) as res:
        port_out = [te.generate(shared_cache_op=TOp.WIPE, **kw, **extra) for _, extra in runs]
    assert_resolved(res.report(), "w8a8 from_pretrained")
    for (name, _), (jt, jl), (tt, tl) in zip(runs, jax_out, port_out):
        assert len(tl) == len(jl) == 6
        np.testing.assert_array_equal(_np(tt), _np(jt), err_msg=name)
        for step, (t, j) in enumerate(zip(tl, jl)):
            assert np.abs(_np(t) - _np(j)).max() <= 1e-3, (name, step)


# --- disable_hierarchy ---------------------------------------------------------


def _hierarchy_run(engine, op, disable_hierarchy, kv_quant=None):
    rng = np.random.RandomState(8)
    shared = rng.randint(1, VOCAB, size=(1, 5)).astype(np.int32)
    suffix = rng.randint(1, VOCAB, size=(2, 3)).astype(np.int32)
    engine.setup_caches(max_unique_batch_size=4, max_unique_seq_length=16 + 6,
                        max_shared_batch_sizes=[1, 2, 4], max_shared_seq_lengths=[8, 8, 4],
                        kv_quant=kv_quant)
    return engine.generate(input_ids=[shared, suffix], num_return_sequences=2, max_new_tokens=6,
                           temperature=0.0, return_logits=True, shared_cache_op=op.WIPE,
                           disable_hierarchy=disable_hierarchy)


def test_disable_hierarchy_consistency(engine):
    """``tests/test_e2e.py::test_disable_hierarchy_consistency`` on the
    port: hierarchy on against the suffixes in the unique cache."""
    tok_on, log_on = _hierarchy_run(engine, TOp, False)
    tok_off, log_off = _hierarchy_run(engine, TOp, True)
    np.testing.assert_array_equal(_np(tok_on), _np(tok_off))
    for a, b in zip(log_on, log_off):
        assert mean_rdiff(_np(a), _np(b)) < 2e-2


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=str)
def test_disable_hierarchy_matches_jax(hf_model, engine, kv_quant):
    """The ablation on the port against the JAX engine's, one HF model in
    fp32 (with an int8 KV cache too): tokens equal, logits within 1e-4."""
    je = JEngine.from_hf_model(hf_model, dtype="float32")
    for off in (False, True):
        tt, tl = _hierarchy_run(engine, TOp, off, kv_quant)
        jt, jl = _hierarchy_run(je, JOp, off, kv_quant)
        np.testing.assert_array_equal(_np(tt), _np(jt))
        for a, b in zip(tl, jl):
            assert np.abs(_np(a) - _np(b)).max() <= 1e-4


def test_disable_hierarchy_needs_three_levels(engine):
    engine.setup_caches(4, 22, [1, 2, 4], [8, 8, 4])
    with pytest.raises(AssertionError, match="3 levels"):
        engine.generate(input_ids=[np.ones((2, 3), np.int32)], num_return_sequences=2,
                        max_new_tokens=2, temperature=0.0, shared_cache_op=TOp.WIPE,
                        disable_hierarchy=True)
