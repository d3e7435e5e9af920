"""The port's synthetic data pipeline on the CPU: ``make_batch`` bitwise
equal to repro's — tokens, labels, ``embeds`` and ``enc_embeds``, with
their dtypes — for one reduced arch per family at two steps and two
seeds, and the two pipeline tests of tests/test_checkpoint.py
(determinism across a restart, prefetch order) on the port."""

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.configs.base import ShapeCell as JShapeCell
from repro.data import make_batch as j_make_batch
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.data import make_batch, prefetch, synthetic_batches

FAMILIES = ["granite-3-2b", "dbrx-132b", "mamba2-130m", "zamba2-2.7b",
            "internvl2-1b", "whisper-small"]


@pytest.mark.parametrize("name", FAMILIES)
def test_make_batch_is_bitwise_repro(name):
    jcfg, cfg = j_reduced(J_ARCHS[name]), reduced(ARCHS[name])
    jcell, cell = JShapeCell("t", 24, 3, "train"), ShapeCell("t", 24, 3,
                                                             "train")
    for seed in (0, 7):
        for step in (0, 5):
            got = make_batch(cfg, cell, seed, step, device="cpu")
            want = j_make_batch(jcfg, jcell, seed, step)
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                v = np.asarray(v)
                assert str(got[k].dtype).removeprefix("torch.") == \
                    str(v.dtype), k
                assert got[k].device.type == "cpu"
                np.testing.assert_array_equal(got[k].numpy(), v)


def test_data_determinism_across_restart():
    cfg = reduced(ARCHS["granite-3-2b"])
    cell = ShapeCell("t", 16, 4, "train")
    a = make_batch(cfg, cell, seed=42, step=3, device="cpu")
    b = make_batch(cfg, cell, seed=42, step=3, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    c = make_batch(cfg, cell, seed=42, step=4, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])


def test_prefetch_preserves_order():
    cfg = reduced(ARCHS["granite-3-2b"])
    cell = ShapeCell("t", 8, 2, "train")
    it = synthetic_batches(cfg, cell, seed=1, device="cpu")
    direct = [next(it) for _ in range(4)]
    it2 = prefetch(synthetic_batches(cfg, cell, seed=1, device="cpu"),
                   depth=2)
    fetched = [next(it2) for _ in range(4)]
    for d, f in zip(direct, fetched):
        assert torch.equal(d["tokens"], f["tokens"])


def test_batches_go_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(reduced(ARCHS["granite-3-2b"]),
                   ShapeCell("t", 8, 2, "train"), 0, 0)
