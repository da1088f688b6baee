"""The port's SPR-round demo (``pllmod_tpu_torch/examples/spr_round.py``)
``main(["--device", "cpu"])`` in process: ten rounds at most, thorough
from the second, float64 on the serial engine (~100 s on one CPU
thread, a file of its own so that the suite's workers share it out);
it prints what the JAX package's demo prints."""

from pllmod_tpu_torch.examples import spr_round
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


def test_spr_round_demo_prints_what_the_jax_demo_prints(capsys):
    lnl = spr_round.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for s in ("starting logL", "after model optimization", "SPR round 1:",
              "final tree:"):
        assert s in out
    start = float(out.split("after model optimization: ")[1].split()[0])
    assert lnl >= start
