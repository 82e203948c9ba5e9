"""The port's multi-node evaluator (``chainermn_torch.evaluators``) on 2
gloo ranks: every rank gets the element-wise mean of the ranks' metric
dicts, as the JAX package's ``_mean_dicts`` computes it from the same
dicts (scalars, arrays and tensors alike); mismatched keys raise.
"""

import numpy as np
import pytest
import torch

from chainermn_tpu.evaluators import _mean_dicts as jax_mean_dicts
from chainermn_torch.evaluators import _mean_dicts
from chainermn_torch.testing import run_ranks

_WORKER = """
import numpy as np
import torch
from chainermn_torch import create_communicator, create_multi_node_evaluator

comm = create_communicator("naive", device="cpu")


class Eval:
    def evaluate(self):
        return {"accuracy": 0.25 + 0.5 * RANK,
                "per_class": np.array([RANK, 2.0 * RANK]),
                "loss": torch.tensor(1.0 + RANK)}


out = {"object": create_multi_node_evaluator(Eval(), comm).evaluate(),
       "callable": create_multi_node_evaluator(
           lambda: {"top1": float(RANK)}, comm)()}
try:
    create_multi_node_evaluator(lambda: {f"k{RANK}": 1.0}, comm)()
except ValueError as e:
    out["mismatch"] = str(e)
save(out)
comm.finalize()
"""


def test_two_rank_mean_matches_the_reference():
    got = run_ranks(_WORKER, 2)
    dicts = [{"accuracy": 0.25 + 0.5 * r,
              "per_class": np.array([r, 2.0 * r]), "loss": 1.0 + r}
             for r in range(2)]
    want = jax_mean_dicts(dicts)
    for rank in got:
        assert rank["object"]["accuracy"] == want["accuracy"] == 0.5
        assert rank["object"]["loss"] == want["loss"] == 1.5
        np.testing.assert_array_equal(rank["object"]["per_class"],
                                      want["per_class"])
        assert rank["callable"] == {"top1": 0.5}
        assert "mismatched metric keys" in rank["mismatch"]


def test_mean_dicts_takes_tensors_and_matches_the_reference():
    dicts = [{"a": torch.tensor(2.0), "b": np.ones(3)},
             {"a": 4.0, "b": np.zeros(3)}]
    got = _mean_dicts(dicts)
    want = jax_mean_dicts([{"a": 2.0, "b": np.ones(3)},
                           {"a": 4.0, "b": np.zeros(3)}])
    assert got["a"] == want["a"] == 3.0
    np.testing.assert_array_equal(got["b"], want["b"])
    with pytest.raises(ValueError, match="mismatched"):
        _mean_dicts([{"a": 1}, {"b": 1}])
