"""The port's metric and profiling utilities (crog_tpu_torch/utils/
metrics.py, profiling.py) against crog_tpu/utils's on seeded inputs: IoU
to 1e-6 (float32 division of equal integer counts, in another order for
the mean), the hit and histogram counts exact."""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crog_tpu.utils import metrics as jax_metrics
from crog_tpu.utils import profiling as jax_profiling
from crog_tpu_torch.utils import metrics, profiling


def _logits(seed, b=6, h=24, w=20):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, (b, 1, h, w)).astype(np.float32)
    target = (rng.random((b, 1, h, w)) < 0.4).astype(np.float32)
    return logits, target


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_metrics_equal_jax_package(seed):
    logits, target = _logits(seed)
    t_logits, t_target = torch.from_numpy(logits), torch.from_numpy(target)
    j_logits, j_target = jnp.asarray(logits), jnp.asarray(target)

    iou, pr = metrics.train_mask_metrics(t_logits, t_target, pr_iou=0.3)
    j_iou, j_pr = jax_metrics.train_mask_metrics(j_logits, j_target, pr_iou=0.3)
    np.testing.assert_allclose(float(iou), float(j_iou), rtol=1e-6)
    assert float(pr) == pytest.approx(float(j_pr), rel=1e-6)

    per, hits = metrics.val_mask_metrics(t_logits, t_target, threshold=0.2)
    j_per, j_hits = jax_metrics.val_mask_metrics(j_logits, j_target, threshold=0.2)
    np.testing.assert_allclose(per.numpy(), np.asarray(j_per), rtol=0, atol=1e-6)
    assert hits.shape == (6, 5)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(j_hits))


@pytest.mark.parametrize("ignore", [255, 0])
def test_intersection_and_union_equals_jax_package(ignore):
    rng = np.random.default_rng(3)
    out = rng.integers(0, 5, (4, 16, 16)).astype(np.int32)
    tgt = rng.integers(0, 5, (4, 16, 16)).astype(np.int32)
    tgt[:, :3] = 255
    got = metrics.intersection_and_union(torch.from_numpy(out), torch.from_numpy(tgt), 5,
                                         ignore)
    ref = jax_metrics.intersection_and_union(jnp.asarray(out), jnp.asarray(tgt), 5, ignore)
    for g, r in zip(got, ref):
        assert g.shape == (5,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_step_timer_median_and_sync():
    timer = profiling.StepTimer()
    assert timer.median_ms == 0.0
    for pause in (0.002, 0.03, 0.004):
        timer.start()
        time.sleep(pause)
        timer.stop({"loss": torch.tensor([1.5, 2.0])})
    assert len(timer.times) == 3
    assert 4.0 <= timer.median_ms < 30.0
    assert profiling.force_sync([{"a": torch.tensor(7.0)}]) == 7.0
    assert jax_profiling.force_sync([{"a": jnp.asarray(7.0)}]) == 7.0
    with pytest.raises(TypeError):
        profiling.force_sync({"n": 3})


def test_trace_without_a_directory_does_nothing(tmp_path):
    with profiling.trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None
    with profiling.trace("") as prof:
        pass
    assert prof is None and not list(tmp_path.iterdir())


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert prof is not None
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
