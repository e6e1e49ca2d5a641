"""The port's scripts (``hydragen_torch/scripts/``) against the JAX package's
``scripts/``, on the CPU, at the tiny fp32 preset of ``tests/test_scripts.py``
(2 layers, hidden 64, 4 query heads over 2 kv heads) under the name "tiny",
each side on the same weights: the JAX package's ``init_params`` at key 0,
carried over with ``params_from_numpy`` and handed to the port script by
monkeypatching its ``init_params``. ``generate`` (or the batcher's ``run``)
is recorded on both sides.

- synth, ``--mode all`` meshless and with two levels: the same YAML files
  with the same non-time fields, every ``generate`` call with the same
  inputs and the same greedy tokens, and a second run skips every point;
  ``fits_hbm`` at paper-scale points: False on ``cuda`` where the estimate
  exceeds ``HBM_BYTES``, True on the CPU, and the byte count equal to the
  JAX formula's (found as the JAX function's threshold of ``HBM_BYTES``);
  synth at tp=2 over two gloo ranks against the JAX synth on a 2-device
  mesh: every mode, the no-sharing baseline included, with the same YAMLs
  and ``generate`` calls;
- microbenchmark: ``go_hydragen`` and ``go_baseline`` within 2e-5 max abs
  of their JAX counterparts and of each other, fp32, the same numpy inputs;
- needles: the same YAML fields and ``generate`` calls;
- serving_bench: the same new tokens, request for request;
- run: the same decoded text as the JAX script, fp32 greedy, over a HF
  directory written here with ``chip_smoke.py``'s WordLevel tokenizer,
  meshless and at tp=2;
- summarize_sweep: the same table over one directory of both packages'
  YAMLs;
- every script that runs a model exits nonzero without a card unless given
  ``--device cpu``.

JAX is imported in test bodies only: the spawned ranks import this module.
"""

import contextlib
import importlib.util
import io
import pickle
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from hydragen_torch.core.batching import ContinuousBatcher as TBatcher
from hydragen_torch.core.engine import HydragenLlama as TEngine
from hydragen_torch.models.config import PRESETS as TPRESETS
from hydragen_torch.models.config import ModelConfig as TConfig
from hydragen_torch.scripts import common, microbenchmark, needles, profile_decode
from hydragen_torch.scripts import run as trun
from hydragen_torch.scripts import serving_bench, summarize_sweep, synth
from hydragen_torch.utils import (
    NeedlesBenchmarkResult,
    SynthBenchmarkResult,
    load_yaml_dataclass,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, dtype="float32")
TIMEOUT = 240.0  # seconds a spawn of ranks may take, set-up included
MICRO_TOL = 2e-5  # fp32, max abs
SCRIPTS_WITH_INIT = (synth, needles, serving_bench, profile_decode)


# -- both sides ---------------------------------------------------------------


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "shape") and hasattr(x, "dtype"):  # a JAX array
        return np.asarray(x)
    return x


class Fixed:
    """A stand-in for a script's ``init_params``: the given parameters."""

    def __init__(self, params):
        self.params = params

    def __call__(self, *args, **kw):
        return self.params


class Recorder:
    """Wraps ``cls.<method>`` so each call's keyword arguments and result
    are kept, as numpy."""

    def __init__(self, cls, method: str = "generate", setattr_=setattr):
        self.calls = []
        orig = getattr(cls, method)
        rec = self

        def wrapped(self_, *args, **kw):
            out = orig(self_, *args, **kw)
            rec.calls.append(({k: _np(v) for k, v in kw.items()}, _np(out)))
            return out

        setattr_(cls, method, wrapped)


def _same_calls(a, b):
    assert a and len(a) == len(b)
    for (kw_a, out_a), (kw_b, out_b) in zip(a, b):
        assert set(kw_a) == set(kw_b)
        for k in kw_a:
            va, vb = kw_a[k], kw_b[k]
            if isinstance(va, list):
                assert len(va) == len(vb), k
                for x, y in zip(va, vb):
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)
            else:
                assert np.array_equal(np.asarray(va), np.asarray(vb)), (k, va, vb)
        if isinstance(out_a, dict):
            assert {k: list(v) for k, v in out_a.items()} == \
                {k: list(v) for k, v in out_b.items()}
        else:
            np.testing.assert_array_equal(out_a, out_b)


def jax_params(quantized=False):
    """(JAX params, the port's copy) of the tiny preset at key 0."""
    import tests.conftest  # noqa: F401
    import jax

    from hydragen_tpu.models.config import ModelConfig
    from hydragen_tpu.models.llama import init_params

    from hydragen_torch.models.convert import params_from_numpy

    p = init_params(ModelConfig(**TINY), jax.random.PRNGKey(0), quantized=quantized)
    return p, params_from_numpy(jax.tree.map(np.asarray, p))


def run_jax_script(monkeypatch, name, argv):
    """``scripts/<name>.py`` of the JAX package as ``__main__``, with the
    tiny preset. Returns its standard output."""
    import tests.conftest  # noqa: F401

    from hydragen_tpu.models.config import PRESETS, ModelConfig

    monkeypatch.setitem(PRESETS, "tiny", ModelConfig(**TINY))
    path = str(ROOT / "scripts" / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path] + [str(a) for a in argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(path, run_name="__main__")
    return out.getvalue()


def jax_script_module(name: str):
    import tests.conftest  # noqa: F401

    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def port_tiny(monkeypatch):
    """The tiny preset in the port's PRESETS and the JAX weights in place of
    its scripts' random ones. Returns (JAX params, port params)."""
    monkeypatch.setitem(TPRESETS, "tiny", TConfig(**TINY))
    jp, tp = jax_params()
    for mod in SCRIPTS_WITH_INIT:
        monkeypatch.setattr(mod, "init_params", Fixed(tp))
    return jp, tp


# -- ranks --------------------------------------------------------------------


def _patched_rank(rank, world, fn, params, record_dir, *args):
    """A script's rank function under the test's patches: the tiny preset,
    ``params`` for the scripts' random weights, and ``generate`` recorded
    into ``record_dir/rank<r>.pkl``."""
    TPRESETS["tiny"] = TConfig(**TINY)
    if params is not None:
        for mod in SCRIPTS_WITH_INIT:
            mod.init_params = Fixed(params)
    rec = Recorder(TEngine)
    try:
        return fn(rank, world, *args)
    finally:
        with open(Path(record_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(rec.calls, f)


def patch_ranks(monkeypatch, params, record_dirs):
    """Route the scripts' rank launches through ``_patched_rank``, each
    launch recording into the next of ``record_dirs``."""
    real = common.launch
    dirs = iter(record_dirs)

    def launch(fn, world, *args, **kw):
        kw["timeout"] = TIMEOUT
        return real(_patched_rank, world, fn, params, str(next(dirs)), *args, **kw)

    monkeypatch.setattr(common, "launch", launch)


def rank_calls(record_dir, rank=0):
    with open(Path(record_dir) / f"rank{rank}.pkl", "rb") as f:
        return pickle.load(f)


# -- synth ----------------------------------------------------------------------

SYNTH_ARGS = ["--bs", "2", "--num-shared", "16", "--num-unique", "4", "--preset", "tiny",
              "--iters", "2", "--dtype", "float32"]


def _synth_fields(path):
    r = load_yaml_dataclass(SynthBenchmarkResult, path)
    return (r.mode, r.batch_size, r.num_shared, r.num_unique, r.model, len(r.times),
            len(r.warmup_times), len(r.prefill_times))


def _same_yamls(jdir, tdir, names=None):
    jnames = sorted(p.name for p in jdir.glob("*.yaml"))
    tnames = sorted(p.name for p in tdir.glob("*.yaml"))
    if names is None:
        assert tnames == jnames
        names = jnames
    for n in names:
        assert _synth_fields(tdir / n) == _synth_fields(jdir / n), n


@pytest.mark.parametrize("extra", [["--mode", "all"],
                                   ["--mode", "all", "--levels", "2", "--level2-bs", "2",
                                    "--bs", "4", "--num-shared", "64", "--iters", "1",
                                    "--measure-prefill"]],
                         ids=["flat", "two-levels"])
def test_synth_matches_jax(tmp_path, monkeypatch, port_tiny, extra):
    from hydragen_tpu.core.engine import HydragenLlama as JEngine

    jrec = Recorder(JEngine, setattr_=monkeypatch.setattr)
    run_jax_script(monkeypatch, "synth", [tmp_path / "jax"] + SYNTH_ARGS + extra)
    trec = Recorder(TEngine, setattr_=monkeypatch.setattr)
    written = synth.main([str(tmp_path / "port")] + SYNTH_ARGS + extra + ["--device", "cpu"])
    assert sorted(p.name for p in written) == sorted(
        p.name for p in (tmp_path / "jax").glob("*.yaml"))
    _same_yamls(tmp_path / "jax", tmp_path / "port")
    _same_calls(jrec.calls, trec.calls)

    # Resumable: a second run skips every point.
    n = len(trec.calls)
    mtimes = {p.name: p.stat().st_mtime_ns for p in (tmp_path / "port").glob("*.yaml")}
    assert synth.main([str(tmp_path / "port")] + SYNTH_ARGS + extra + ["--device", "cpu"]) == []
    assert len(trec.calls) == n
    assert {p.name: p.stat().st_mtime_ns for p in (tmp_path / "port").glob("*.yaml")} == mtimes


FIT_POINTS = {
    # the chip phase's point: 32 x 256 x 2,120 x 8,192 B of unique KV alone
    "7b-noshared": ("llama-2-7b", "w8a8", "int8", 256, 2048, 64, "hydragen_noshared", 1, 0,
                    False),
    "7b-hydragen": ("llama-2-7b", "w8a8", "int8", 256, 2048, 64, "hydragen", 1, 0, True),
    "7b-int4-16k": ("llama-2-7b", "w4a8", "int4", 512, 16384, 128, "hydragen", 1, 0, True),
    "8b-bf16-noshared": ("llama-3-8b", None, None, 128, 4096, 128, "hydragen_noshared", 1,
                         0, False),
    "7b-two-levels": ("llama-2-7b", "w8a8", "int8", 256, 4096, 64, "hydragen_nohierarchy", 2,
                      16, True),
    "70b-bf16": ("llama-2-70b", None, None, 32, 1024, 64, "hydragen", 1, 0, False),
}


@pytest.mark.parametrize("point", list(FIT_POINTS))
def test_fits_hbm_binds_on_cuda_with_the_jax_formula(monkeypatch, point):
    import tests.conftest  # noqa: F401
    import jax

    import hydragen_tpu.utils.capacity as jcap
    from hydragen_tpu.models.config import PRESETS as JPRESETS

    preset, quant, kv, bs, ns, nu, mode, levels, l2, fits = FIT_POINTS[point]
    args = (quant, kv, bs, ns, nu, mode, levels)
    need = synth.hbm_bytes(TPRESETS[preset], *args, level2_bs=l2)
    assert synth.fits_hbm(TPRESETS[preset], *args, level2_bs=l2, device="cuda") is fits
    assert (need < synth.HBM_BYTES) is fits
    assert synth.fits_hbm(TPRESETS[preset], *args, level2_bs=l2, device="cpu") is True
    # The JAX function binds only on a TPU; there its byte count is the
    # HBM_BYTES at which the answer turns.
    jsynth = jax_script_module("synth")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for limit, want in ((need, False), (need + 1, True)):
        monkeypatch.setattr(jcap, "HBM_BYTES", limit)
        assert jsynth.fits_hbm(JPRESETS[preset], *args, level2_bs=l2) is want


def test_synth_over_two_ranks_matches_jax_mesh(tmp_path, monkeypatch, port_tiny):
    from hydragen_tpu.core.engine import HydragenLlama as JEngine

    args = SYNTH_ARGS + ["--iters", "1", "--tp", "2"]
    jrec = Recorder(JEngine, setattr_=monkeypatch.setattr)
    run_jax_script(monkeypatch, "synth", [tmp_path / "jax", "--mode", "all"] + args)
    rec = tmp_path / "rec"
    rec.mkdir()
    patch_ranks(monkeypatch, port_tiny[1], [rec])
    out = tmp_path / "port"
    # --mode all: hydragen, then the no-sharing baseline over the ranks, then
    # noattention, each point's YAML as the JAX mesh writes it.
    written = synth.main([str(out), "--mode", "all", "--device", "cpu"] + args)
    names = ["hydragen_bs2_ns16_nu4.yaml", "hydragen_noshared_bs2_ns16_nu4.yaml",
             "noattention_bs2_ns16_nu4.yaml"]
    assert sorted(p.name for p in written) == names
    assert sorted(p.name for p in out.glob("*.yaml")) == names
    _same_yamls(tmp_path / "jax", out)
    calls = rank_calls(rec, 0)
    assert sum(bool(c[0]["disable_hydragen"]) for c in calls) == 3  # 2 warm-up, 1 timed
    _same_calls(jrec.calls, calls)
    _same_calls(calls, rank_calls(rec, 1))  # every rank gets the whole batch


@pytest.mark.parametrize("script,argv,points", [
    ("synth", ["--mode", "all", "--bs", "2,4", "--tp", "2"], 6),
    ("synth", ["--mode", "hydragen", "--num-unique", "4:16:x2", "--dp", "2"], 3),
    ("synth", ["--mode", "all", "--levels", "2", "--tp", "2"], 3),
    ("needles", ["--num-questions", "2:64:x2", "--tp", "2"], 6)])
def test_rank_time_limit_scales_with_the_sweep(tmp_path, monkeypatch, script, argv, points):
    seen = {}

    def launch(fn, world, *args, timeout, **kw):
        seen.update(world=world, timeout=timeout)
        return [[]]

    monkeypatch.setattr(common, "launch", launch)
    {"synth": synth, "needles": needles}[script].main(
        [str(tmp_path), "--device", "cpu"] + argv)
    assert seen == dict(world=2, timeout=common.RANK_SETUP_S + points * common.RANK_POINT_S)


# -- microbenchmark ---------------------------------------------------------------


@pytest.mark.parametrize("bs,ns,nu,hq,hkv,d", [(4, 64, 16, 4, 2, 64), (4, 64, 0, 4, 2, 64),
                                              (3, 40, 8, 8, 1, 128)])
def test_microbenchmark_ops_match_jax(bs, ns, nu, hq, hkv, d):
    import tests.conftest  # noqa: F401
    import jax.numpy as jnp

    jm = jax_script_module("microbenchmark")
    rng = np.random.RandomState(bs * ns + nu)
    arrs = [rng.randn(*s).astype(np.float32) for s in
            ((bs, 1, hq, d), (1, ns, hkv, d), (1, ns, hkv, d))]
    arrs += [rng.randn(bs, nu, hkv, d).astype(np.float32) if nu else None for _ in range(2)]
    outs = {}
    for name, mod, conv in (("jax", jm, jnp.asarray), ("port", microbenchmark,
                                                       torch.from_numpy)):
        for mode in ("hydragen", "baseline"):
            op, args = getattr(mod, f"go_{mode}")(
                *[None if a is None else conv(a) for a in arrs], nu, bs)
            outs[name, mode] = np.asarray(_np(op(*args)))
    for mode in ("hydragen", "baseline"):
        assert outs["port", mode].shape == (bs, 1, hq, d)
        assert np.abs(outs["port", mode] - outs["jax", mode]).max() <= MICRO_TOL, mode
    assert np.abs(outs["port", "hydragen"] - outs["port", "baseline"]).max() <= MICRO_TOL


def test_microbenchmark_script_on_the_cpu(tmp_path):
    out = tmp_path / "micro"
    argv = [str(out), "--bs", "4", "--num-shared", "64", "--num-unique", "0,16", "--qheads", "4",
            "--kvheads", "2", "--dim", "64", "--iters", "3", "--dtype", "float32",
            "--device", "cpu"]
    res = microbenchmark.main(argv)
    assert len(list(out.glob("*.yaml"))) == 4 and len(res) == 4
    assert all(len(r.times) == 3 and r.mean_time > 0 for r in res)
    assert microbenchmark.main(argv) == []


# -- needles, serving_bench, run, profile_decode, summarize_sweep -------------------


def test_needles_matches_jax(tmp_path, monkeypatch, port_tiny):
    from hydragen_tpu.core.engine import HydragenLlama as JEngine

    argv = ["--preset", "tiny", "--haystack-chars", "2000", "--num-needles", "4",
            "--num-questions", "2,3", "--max-new-tokens", "3"]
    jrec = Recorder(JEngine, setattr_=monkeypatch.setattr)
    run_jax_script(monkeypatch, "needles", [tmp_path / "jax"] + argv)
    trec = Recorder(TEngine, setattr_=monkeypatch.setattr)
    res = needles.main([str(tmp_path / "port")] + argv + ["--device", "cpu"])
    assert [r.num_questions for r in res] == [2, 3]
    _same_calls(jrec.calls, trec.calls)
    for n in (2, 3):
        j, t = (load_yaml_dataclass(NeedlesBenchmarkResult, d / f"needles_q{n}.yaml")
                for d in (tmp_path / "jax", tmp_path / "port"))
        for f in ("num_questions", "haystack_chars", "num_correct", "accuracy_by_decile",
                  "counts_by_decile"):
            assert getattr(t, f) == getattr(j, f), f


def test_serving_bench_matches_jax(monkeypatch, port_tiny):
    import tests.conftest  # noqa: F401

    from hydragen_tpu.core.batching import ContinuousBatcher as JBatcher

    jp, tp = jax_params(quantized="int8")
    for mod in SCRIPTS_WITH_INIT:
        monkeypatch.setattr(mod, "init_params", Fixed(tp))
    argv = ["--preset", "tiny", "--quantization", "int8", "--requests", "6", "--pool", "4",
            "--shared", "16", "--prompt-len", "4", "--budget", "2:6", "--chunk", "2"]
    jrec = Recorder(JBatcher, "run", setattr_=monkeypatch.setattr)
    run_jax_script(monkeypatch, "serving_bench", argv)
    trec = Recorder(TBatcher, "run", setattr_=monkeypatch.setattr)
    res = serving_bench.main(argv + ["--device", "cpu"])
    assert res["requests"] == 6 and len(trec.calls) == 3 == len(jrec.calls)
    want, got = jrec.calls[0][1], trec.calls[0][1]
    assert sorted(got) == sorted(want)
    assert {r: len(t) for r, t in got.items()} == {r: len(t) for r, t in want.items()}
    _same_calls(jrec.calls, trec.calls)


def _write_hf_dir(path: Path) -> None:
    """A 2-layer Llama at the tiny widths (random, fp32) and
    ``chip_smoke.py``'s WordLevel tokenizer over w0 ... w124 plus <unk>, <s>
    and </s>, BOS added at encode."""
    import transformers

    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=TINY["vocab_size"], hidden_size=TINY["hidden_size"],
        intermediate_size=TINY["intermediate_size"], num_hidden_layers=2,
        num_attention_heads=TINY["num_attention_heads"],
        num_key_value_heads=TINY["num_key_value_heads"], bos_token_id=1, eos_token_id=2)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(path)
    chip_smoke.write_wordlevel_tokenizer(path, TINY["vocab_size"])


RUN_ARGS = ["--prompts", "w5 w6 w7 w8 w9", "w1 w2|w3 w4", "--num-return-sequences", "2",
            "--max-new-tokens", "6", "--dtype", "float32"]


@pytest.mark.parametrize("tp", [1, 2])
def test_run_matches_jax(tmp_path, monkeypatch, tp):
    ckpt = tmp_path / "ckpt"
    _write_hf_dir(ckpt)
    argv = [str(ckpt)] + RUN_ARGS + (["--tp", str(tp)] if tp > 1 else [])
    text = run_jax_script(monkeypatch, "run", argv)
    want = [b.rstrip("\n") for b in text.split("---\n")[1:]]
    if tp > 1:
        (tmp_path / "rec").mkdir()
        patch_ranks(monkeypatch, None, [tmp_path / "rec"])
    res = trun.main(argv + ["--device", "cpu"])
    assert len(want) == 4 and res["texts"] == want
    assert res["tokens"].shape[0] == 4
    assert 0 <= res["tokens"].min() and res["tokens"].max() < TINY["vocab_size"]


def test_profile_decode_on_the_cpu(monkeypatch, port_tiny):
    res = profile_decode.main(["--model", "tiny", "--bs", "4", "--shared", "16", "--new", "8",
                               "--steps", "4", "--quant", "none", "--kv", "none", "--top", "5",
                               "--device", "cpu"])
    s = res["summary"]
    assert res["decode_ms_per_step"] > 0 and s.steps == 4 and len(s.ops) == 5
    assert s.busy_ms > 0 and s.kernels > 0


def test_summarize_sweep_prints_the_jax_table(tmp_path, monkeypatch):
    import tests.conftest  # noqa: F401

    from hydragen_tpu.utils import results as jres

    from hydragen_torch.utils import results as tres

    dirs = [tmp_path / "sweep", tmp_path / "sweep_kv8"]
    for i, (bs, ns) in enumerate([(32, 1024), (32, 16384), (64, 1024), (64, 16384),
                                  (64, 4096)]):
        for d, mod in zip(dirs, (jres, tres) if i % 2 else (tres, jres)):
            for mode in ("hydragen", "noattention"):
                r = mod.SynthBenchmarkResult(mode=mode, batch_size=bs, num_shared=ns,
                                             num_unique=64, times=[0.5 + 0.01 * i, 0.6])
                mod.save_yaml_dataclass(r, d / f"{mode}_bs{bs}_ns{ns}_nu64.yaml")
    want = run_jax_script(monkeypatch, "summarize_sweep", dirs)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summarize_sweep.main([str(d) for d in dirs])
    assert out.getvalue() == want and "(int8 KV)" in want


NEED_CARD = {
    "synth": (synth, ["out"]),
    "microbenchmark": (microbenchmark, ["out"]),
    "needles": (needles, ["out"]),
    "serving_bench": (serving_bench, []),
    "run": (trun, ["ckpt", "--prompts", "hi"]),
    "profile_decode": (profile_decode, []),
}


@pytest.mark.parametrize("name", list(NEED_CARD))
def test_scripts_need_a_card(tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, argv = NEED_CARD[name]
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code == f"{name}: no CUDA device is available; pass --device cpu to run " \
        "on the CPU"
    assert list(tmp_path.iterdir()) == []  # nothing written, nothing run


def test_script_without_a_card_exits_nonzero_with_one_line(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-m", "hydragen_torch.scripts.synth", "out"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert out.stderr.strip().splitlines() == [
        "synth: no CUDA device is available; pass --device cpu to run on the CPU"]
