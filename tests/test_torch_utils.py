"""The port's utilities and data module against the JAX package's, on the CPU.

- ``hydragen_torch.utils.results.split_range`` gives what
  ``hydragen_tpu.utils.results.split_range`` gives on every spec of a list,
  bad specs included (the same exception type);
- ``rdiff``, ``mean`` and ``std`` equal (the same float64 arithmetic), and
  ``dtype_map`` names the same dtypes;
- a result YAML written by either package loads in the other with equal
  fields and properties, and the two packages write the same bytes;
- ``make_needle_haystack`` builds the identical document and needles
  (sentence, question, answer and position, exactly) at several sizes, with
  and without a corpus file; ``needles.extract_answer`` and
  ``score_answers`` of both scripts agree on a set of texts;
- ``utils/profiling``: the name folding, the grouping, and a CPU trace's
  sums; ``utils/timing.timed`` on the CPU.
Every comparison here is exact.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the CPU platform before jax)

import jax.numpy as jnp
import torch

from hydragen_tpu.data import haystack as jhay
from hydragen_tpu.utils import misc as jmisc
from hydragen_tpu.utils import results as jres

from hydragen_torch.data import haystack as thay
from hydragen_torch.scripts import needles as tneedles
from hydragen_torch.utils import misc as tmisc
from hydragen_torch.utils import profiling
from hydragen_torch.utils import results as tres
from hydragen_torch.utils.timing import timed

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def jax_script(name: str):
    """The JAX package's ``scripts/<name>.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SPECS = ["1,2,5", "8", "1:4", "0:8:2", "32:256:x2", "1:100:x10", "2:64:x2", "512:4096:x2",
         "5:3", "0:0", "-2:2", "3,", "1:2:3:4", "7:7:x3",
         # bad specs: both raise
         "", "a", "1:x", "1:8:xa", "1:2:0", "1,,b"]


@pytest.mark.parametrize("spec", SPECS)
def test_split_range_matches_jax(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except Exception as e:  # the exception's type is the outcome
            return type(e)

    want = outcome(jres.split_range)
    assert outcome(tres.split_range) == want


def test_rdiff_mean_std_and_dtype_map_match_jax():
    rng = np.random.RandomState(3)
    for _ in range(5):
        a, b = rng.randn(37), rng.randn(37)
        assert tmisc.rdiff(a, b) == jmisc.rdiff(a, b)
        xs = list(rng.rand(11))
        assert tmisc.mean(xs) == jmisc.mean(xs)
        assert tmisc.std(xs) == jmisc.std(xs)
    assert set(tmisc.dtype_map) == set(jmisc.dtype_map)
    for k, v in tmisc.dtype_map.items():
        assert str(v).split(".")[-1] == jnp.dtype(jmisc.dtype_map[k]).name, k


def _samples(mod):
    return [
        mod.SynthBenchmarkResult(mode="hydragen", batch_size=256, num_shared=2048,
                                 num_unique=64, model="llama-2-7b", times=[1.25, 1.5, 1e-5],
                                 warmup_times=[3.0], prefill_times=[0.125]),
        mod.MicrobenchmarkResult(batch_size=512, num_shared=2048, num_unique=128,
                                 num_qheads=8, num_kvheads=1, head_dim=128, mode="baseline",
                                 times=[2.5e-4, 2.75e-4]),
        mod.NeedlesBenchmarkResult(num_questions=4, haystack_chars=65536, num_correct=3,
                                   accuracy_by_decile=[1.0, 0.5] + [0.0] * 8,
                                   counts_by_decile=[1, 2] + [0] * 8,
                                   shared_prefill_time=0.75, decode_times=[0.5]),
    ]


PROPS = {"SynthBenchmarkResult": ("mean_time", "throughput", "rstd"),
         "MicrobenchmarkResult": ("mean_time", "std_time", "rstd"),
         "NeedlesBenchmarkResult": ("accuracy",)}


@pytest.mark.parametrize("which", range(3))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_result_yaml_loads_in_the_other_package(tmp_path, which, writer):
    src, dst = (jres, tres) if writer == "jax" else (tres, jres)
    obj = _samples(src)[which]
    name = type(obj).__name__
    path = tmp_path / f"{name}.yaml"
    src.save_yaml_dataclass(obj, path)
    loaded = dst.load_yaml_dataclass(getattr(dst, name), path)
    assert src.dataclass_to_dict(obj) == dst.dataclass_to_dict(loaded)
    for prop in PROPS[name]:
        assert getattr(loaded, prop) == getattr(obj, prop), prop
    # Both packages write the same bytes.
    other = tmp_path / "other.yaml"
    dst.save_yaml_dataclass(loaded, other)
    assert other.read_bytes() == path.read_bytes()


CORPUS = ("The mill stood by the river. Its wheel turned slowly.\nNobody came that winter. "
          * 40)


@pytest.mark.parametrize("chars,needles,corpus", [
    (2000, 4, False), (5000, 8, False), (65536, 64, False), (3000, 5, True),
    (20000, 16, True)])
def test_haystack_matches_jax(tmp_path, chars, needles, corpus):
    path = None
    if corpus:
        path = tmp_path / "corpus.txt"
        path.write_text(CORPUS)
    jdoc, jn = jhay.make_needle_haystack(chars, needles, corpus_path=path)
    tdoc, tn = thay.make_needle_haystack(chars, needles, corpus_path=path)
    assert tdoc == jdoc
    assert [(n.sentence, n.question, n.answer, n.position_in_doc) for n in tn] == \
        [(n.sentence, n.question, n.answer, n.position_in_doc) for n in jn]


TEXTS = ["answer### Blue and more", "answer### yellow", "answer### GREEN", "answer### Blue",
         "###answer###   Green###", "no marker here", "answer###  red.", "### White fur",
         "", "answer### 42"]


def test_needles_answers_and_scores_match_jax():
    jneedles = jax_script("needles")
    for text in TEXTS + ["###" + t for t in TEXTS]:
        assert tneedles.extract_answer(text) == jneedles.extract_answer(text), text
    _, jn = jhay.make_needle_haystack(4000, 8)
    _, tn = thay.make_needle_haystack(4000, 8)
    texts = [f"answer### {n.answer if i % 3 else 'purple'}" for i, n in enumerate(tn)] + TEXTS
    assert tneedles.score_answers(texts, tn) == jneedles.score_answers(texts, jn)


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::flash_kernel<128, true>(Params)", "flash_kernel"),
    ("void (anonymous namespace)::decode_kernel<128, 8>(DecodeArgs)", "decode_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >(int)",
     "at::native::vectorized_elementwise_kernel"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
    ("aten::mm", "aten::mm")])
def test_fold_name(name, want):
    assert profiling.fold_name(name) == want


def test_group_ms_and_cpu_trace():
    table = {"w8a8_kernel<1>": (1000.0, 4), "w8a8_kernel<2>": (500.0, 2),
             "flash_kernel<3>": (250.0, 1), "elementwise": (100.0, 8)}
    assert profiling.group_ms(table, ["w8a8_kernel", "flash_kernel"], per=2) == \
        {"w8a8_kernel": 0.75, "flash_kernel": 0.125, "other": 0.05}
    assert profiling.group_ms(table, ["w8a8_kernel", "decode_kernel"], other=None) == \
        {"w8a8_kernel": 1.5, "decode_kernel": 0.0}

    a = torch.randn(64, 64)
    with profiling.trace("cpu") as tr:
        for _ in range(3):
            a = torch.tanh(a @ a)
    assert tr.wall_ms > 0
    s = profiling.step_summary(tr, steps=3, top=1000)
    names = {st.name for st in s.ops}
    assert {"aten::mm", "aten::tanh"} <= names
    assert sum(st.total_ms for st in s.ops) == pytest.approx(s.busy_ms)
    assert sum(st.fraction for st in s.ops) == pytest.approx(1.0)
    assert [st.total_ms for st in profiling.op_summary(tr, top=2)] == \
        sorted((st.total_ms for st in s.ops), reverse=True)[:2]


def test_trace_decode_traces_the_loop_and_puts_it_back():
    class Engine:
        device = torch.device("cpu")

        def _decode_steps(self, x):
            return torch.tanh(x @ x)

    eng = Engine()
    own = eng._decode_steps
    a = torch.randn(32, 32)
    tr = profiling.trace_decode(eng, lambda: [eng._decode_steps(a), torch.exp(a)])
    names = set(profiling.kernel_table(tr.prof, "cpu"))
    assert {"aten::mm", "aten::tanh"} <= names and "aten::exp" not in names
    assert eng._decode_steps == own
    with pytest.raises(RuntimeError, match="no decode step"):
        profiling.trace_decode(eng, lambda: torch.exp(a))
    assert eng._decode_steps == own


def test_timed_on_the_cpu():
    calls = []
    times, warm = timed(lambda: calls.append(1), num_iters=4, num_warmup=2,
                        between_fn=lambda: None, device="cpu")
    assert len(times) == 4 and len(warm) == 2 and len(calls) == 6
    assert all(t >= 0 for t in times + warm)
