"""The port's docstring examples, one test case a docstring.

Runs every ``>>>`` example in ``repro_torch.api``, ``repro_torch.updates``,
``repro_torch.obs.trace``, ``repro_torch.core.cauchy`` and
``repro_torch.core.eigh_update`` with ``doctest`` (ELLIPSIS on), so each
counts in tier-1.  The examples run on the CPU (``device="cpu"``) and are
checked by their own printed values.  Nothing here imports JAX.
"""

from __future__ import annotations

import doctest
import importlib
import io
import pkgutil

import pytest

PACKAGES = ("repro_torch.api", "repro_torch.updates")
MODULES = ("repro_torch.obs.trace", "repro_torch.core.cauchy", "repro_torch.core.eigh_update")


def _module_names() -> list[str]:
    names = []
    for pkg_name in PACKAGES:
        pkg = importlib.import_module(pkg_name)
        names.append(pkg_name)
        names += [f"{pkg_name}.{m.name}" for m in pkgutil.iter_modules(pkg.__path__)]
    return names + list(MODULES)


def _doctests() -> list:
    finder = doctest.DocTestFinder()
    cases = []
    for name in _module_names():
        for test in finder.find(importlib.import_module(name)):
            if test.examples:
                cases.append(pytest.param(test, id=test.name))
    return cases


DOCTESTS = _doctests()


def test_every_listed_surface_has_examples():
    names = {p.values[0].name for p in DOCTESTS}
    for want in ("repro_torch.api", "repro_torch.api.state.SvdState.from_dense",
                 "repro_torch.api.state.SvdState.from_factors",
                 "repro_torch.api.state.SvdState.materialize",
                 "repro_torch.api.state.SvdState.truncate", "repro_torch.api.state.as_state",
                 "repro_torch.api.policy.UpdatePolicy.resolve_method",
                 "repro_torch.api.update.engine_for", "repro_torch.api.update.update",
                 "repro_torch.api.update.update_many", "repro_torch.api.update.update_rank_k",
                 "repro_torch.updates.sketch.factored_svd", "repro_torch.updates.sketch.range_finder",
                 "repro_torch.updates.sketch.sketch_svd",
                 "repro_torch.updates.sketch.sparse_sketch_svd", "repro_torch.obs.trace.span",
                 "repro_torch.core.cauchy.cauchy_matvec",
                 "repro_torch.core.eigh_update.eigh_update"):
        assert want in names, want


@pytest.mark.parametrize("test", DOCTESTS)
def test_docstring_example(test):
    from repro_torch import obs

    out = io.StringIO()
    runner = doctest.DocTestRunner(optionflags=doctest.ELLIPSIS)
    try:
        result = runner.run(test, out=out.write)
    finally:
        obs.stop_tracing()
        obs.clear_trace()
    assert result.failed == 0, out.getvalue()
