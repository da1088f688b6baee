"""The port's search demos ``ml_search_demo`` and
``constrained_search_demo`` (``pllmod_tpu_torch/examples``), each
``main(["--device", "cpu"])`` in process, print what the JAX package's
demos print (the strings ``tests/test_examples_smoke.py`` asserts)."""

import pytest

from pllmod_tpu_torch.examples import constrained_search_demo, ml_search_demo
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("demo,strings", [
    (ml_search_demo, ("parsimony starting tree", "search:",
                      "final tree:")),
    (constrained_search_demo, ("constrained parsimony start",
                               "constraint satisfied: True")),
], ids=["ml_search", "constrained_search"])
def test_search_demo_prints_what_the_jax_demo_prints(demo, strings, capsys):
    demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for s in strings:
        assert s in out
