"""The port's native reconstruction schemes (``native/src/schemes.cc``,
``traceweaver_tpu_torch.native.run_scheme``) against the JAX package's
``traceweaver_tpu.native.run_scheme`` on ``tests/test_native.py``'s
inputs (each solvable service's packed partitions), and against the
port's Python baselines, as ``tests/test_native.py`` holds the JAX
package's. The reference's hotel corpus is not in the repository, so the
services are those of a synthesized Alibaba call graph. CPU only."""

import copy
import os
import random
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from traceweaver_tpu_torch import native  # noqa: E402
from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus  # noqa: E402
from traceweaver_tpu_torch.ingest import build_service_problem, load_corpus  # noqa: E402

SCHEMES = [("fcfs", "FCFS"), ("vpath", "VPath"), ("vpath_old", "VPathOld")]


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    (d,) = synthesize_corpus(str(tmp_path_factory.mktemp("cg")), n_graphs=1,
                             traces_per_graph=300, seed=10)
    random.seed(10)
    store = load_corpus(d, fix=5, max_traces=300, cache=False)
    probs = [build_service_problem(store, svc) for svc in sorted(store.out_spans_by_process)]
    probs = [p for p in probs if not p.skipped]
    assert len(probs) >= 3
    return store, probs


def _arrays(prob):
    """``tests/test_native.py``'s ``_problem_arrays`` packing."""
    from tests.test_native import _problem_arrays

    return _problem_arrays(prob)


@pytest.mark.parametrize("scheme", [s for s, _ in SCHEMES])
def test_run_scheme_equals_jax(problems, scheme):
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    from traceweaver_tpu import native as j_native

    _, probs = problems
    for prob in probs:
        eps, _, _, arrays = _arrays(prob)
        got = native.run_scheme(scheme, *arrays, n_eps=len(eps))
        want = j_native.run_scheme(scheme, *arrays, n_eps=len(eps))
        assert want is not None
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and got.shape == (len(eps), len(arrays[0]))


@pytest.mark.parametrize("scheme,cls_name", SCHEMES)
def test_run_scheme_equals_the_python_baselines(problems, scheme, cls_name):
    import traceweaver_tpu_torch.algorithms as algos
    from traceweaver_tpu_torch.metrics import get_ground_truth

    store, probs = problems
    cls = getattr(algos, cls_name)
    for prob in probs:
        truth = get_ground_truth(prob.in_span_partitions, prob.out_span_partitions)
        expected = cls(store.all_spans, store.all_processes).FindAssignments(
            cls_name, prob.process, copy.deepcopy(prob.in_span_partitions),
            copy.deepcopy(prob.out_span_partitions), False, [], truth)
        got = native.scheme_assignments(scheme, prob.in_span_partitions,
                                        prob.out_span_partitions)
        for ep in prob.out_span_partitions:
            assert got[ep] == dict(expected[ep]), (scheme, prob.process, ep)


def test_unknown_scheme_and_failed_build_raise(tmp_path, monkeypatch):
    with pytest.raises(KeyError):
        native.run_scheme("nope", [], [], [], [], [], [], [], n_eps=1)
    bad = tmp_path / "schemes.cc"
    bad.write_text('#include "missing_schemes_header.hpp"\n')
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCES", native.SOURCES[:2] + (str(bad),))
    with pytest.raises(native.NativeLoaderError, match="missing_schemes_header"):
        native.run_scheme("fcfs", [0.0], [1.0], [0], [], [], [], [], n_eps=1)
