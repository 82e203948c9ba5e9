"""The port's ``warmup_cosine_decay_schedule``
(``chainermn_torch.optimizers``) against optax's, step by step, as the
ImageNet trainer calls it (``train_imagenet.py:338-353``) and with the
end value and exponent optax also takes; and the step-to-update mapping
through ``LambdaLR``.

Tolerance: rtol 1e-6, atol 1e-7 — optax evaluates in float32, the port
in float64; near the end of the decay ``1 + cos`` is rounded to float32
against 1, about 1e-8 of the peak value absolute.
"""

import numpy as np
import optax
import pytest
import torch

from chainermn_torch.optimizers import warmup_cosine_decay_schedule

# (init, peak, warmup, decay, end, exponent)
CASES = {
    "recipe": (0.0, 0.1 * 512 / 256, 5 * 40, 90 * 40, 0.0, 1.0),
    "short_warmup": (0.0, 0.05, 1, 2, 0.0, 1.0),
    "end_value_exponent": (0.01, 0.4, 7, 50, 1e-3, 2.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_every_step_matches_optax(case):
    init, peak, warmup, decay, end, exponent = CASES[case]
    want = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay,
                                              end, exponent)
    got = warmup_cosine_decay_schedule(init, peak, warmup, decay, end,
                                       exponent)
    steps = range(decay + 10)
    np.testing.assert_allclose([got(t) for t in steps],
                               [float(want(t)) for t in steps],
                               rtol=1e-6, atol=1e-7)


def test_lambda_lr_applies_the_step_count_as_optax_does():
    """Update t runs at schedule(t): the first at schedule(0), then one
    scheduler step per optimizer step."""
    sched = warmup_cosine_decay_schedule(0.0, 0.2, 3, 10)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1.0)
    lr = torch.optim.lr_scheduler.LambdaLR(opt, sched)
    seen = []
    for _ in range(12):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        lr.step()
    np.testing.assert_allclose(seen, [sched(t) for t in range(12)],
                               rtol=0, atol=0)


def test_rejects_a_cosine_part_of_no_steps():
    with pytest.raises(ValueError, match="decay_steps"):
        warmup_cosine_decay_schedule(0.0, 0.1, 5, 5)
