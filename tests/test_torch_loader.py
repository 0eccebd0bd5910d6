"""The port's host loader and sample cache against the JAX package's:
``DataLoader`` batches (shuffle, drop_last, pad_last_batch, a 2-host
stripe) equal crog_tpu's over two epochs; the thread and forkserver
process pools give identical batches; an exception in a worker, in collate
or in the put stage reaches the consumer; ``DevicePut`` (on the CPU here)
moves every dense field and leaves ragged ones; ``SampleCache`` mirrors
tests/test_sample_cache.py.  Batches are compared exactly: the same numpy
arithmetic on both sides.
"""

import pickle
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from crog_tpu.data.loader import DataLoader as JaxDataLoader
from crog_tpu.data.synthetic import SyntheticOCIDVLG as JaxSynthetic
from crog_tpu_torch.data.cache import SampleCache
from crog_tpu_torch.data.loader import DataLoader, DevicePut, device_put_crog
from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG


def _ds(cls=SyntheticOCIDVLG, n=7):
    return cls(num_samples=n, input_size=32, ori_hw=(60, 80), raw="lb")


def assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(np.asarray(g[k]), v, err_msg=k)
            elif k == "grasps":
                for a, b in zip(g[k], v):
                    np.testing.assert_array_equal(a, b)
            else:
                assert g[k] == v, k


CASES = {
    "shuffle": dict(shuffle=True),
    "drop_last": dict(shuffle=True, drop_last=True),
    "pad_last_batch": dict(pad_last_batch=True),
    "two_hosts": dict(shuffle=True, num_hosts=2, host_id=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batches_equal_jax_package(case):
    kw = dict(batch_size=3, seed=4, num_workers=2, **CASES[case])
    ref_loader = JaxDataLoader(_ds(JaxSynthetic), **kw)
    loader = DataLoader(_ds(), **kw)
    assert len(loader) == len(ref_loader)
    for epoch in (0, 1):
        ref_loader.set_epoch(epoch)
        loader.set_epoch(epoch)
        ref = list(ref_loader)
        got = list(loader)
        assert_batches_equal(got, ref)
        assert loader.batch_count == len(got) == len(loader)
    if case == "pad_last_batch":
        assert got[-1]["n_valid"] == 1 and len(got[-1]["word"]) == 3
    loader.close()


def test_thread_and_process_pools_give_identical_batches():
    """The forkserver pool: no fork-after-threads warning, the same batches
    as the thread pool (a SampleCache reaches each worker empty)."""
    ds = SampleCache(_ds(n=8))
    ref = list(DataLoader(ds, 4, shuffle=True, num_workers=3))
    with DataLoader(ds, 4, shuffle=True, num_procs=2) as loader:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = list(loader)
        assert loader._workers is not None
    assert loader._workers is None  # closed
    assert not [w for w in caught if "fork" in str(w.message).lower()]
    assert_batches_equal(got, ref)


class _Seq:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 9 and getattr(self, "poisoned", False):
            raise RuntimeError("corrupt sample 9")
        return {"img": np.full((2, 2, 3), i, np.float32), "word": np.full(17, i, np.int32),
                "sentence": f"s{i}"}


def _bad_collate(samples):
    raise ValueError("collate failed")


def _bad_put(batch):
    raise OSError("copy failed")


@pytest.mark.parametrize("stage", ["worker", "worker_through_put", "collate", "put"])
def test_exceptions_reach_the_consumer(stage):
    ds = _Seq()
    ds.poisoned = stage.startswith("worker")
    kw = {"collate": dict(collate_fn=_bad_collate), "put": dict(device_put_fn=_bad_put),
          "worker_through_put": dict(device_put_fn=DevicePut("cpu"))}.get(stage, {})
    msg = {"collate": "collate failed", "put": "copy failed"}.get(stage, "corrupt sample 9")
    got = []
    with DataLoader(ds, 4, num_workers=2, **kw) as loader:
        with pytest.raises((RuntimeError, ValueError, OSError), match=msg):
            for batch in loader:
                got.append(batch)
    assert len(got) < 3  # the epoch does not look complete


def test_put_stage_moves_dense_fields_in_order():
    calls = []

    class Put(DevicePut):
        def __call__(self, batch):
            calls.append(int(batch["word"][0, 0]))
            return super().__call__(batch)

    with DataLoader(_Seq(), 5, num_workers=2, pad_last_batch=True,
                    device_put_fn=Put("cpu")) as loader:
        got = list(loader)
    assert calls == [0, 5, 10]
    assert [int(b["word"][0, 0]) for b in got] == [0, 5, 10]
    last = got[-1]
    assert torch.is_tensor(last["img"]) and torch.is_tensor(last["word"])
    assert last["sentence"] == ["s10", "s11", "s11", "s11", "s11"]
    assert last["n_valid"] == 2
    np.testing.assert_array_equal(last["word"].numpy()[:, 0], [10, 11, 11, 11, 11])
    # fields already on the device pass through the step's copy unchanged
    again = device_put_crog(last, ("img", "word"), "cpu")
    assert again["img"] is last["img"] and again["word"] is last["word"]


# ---- SampleCache (tests/test_sample_cache.py) ----

def test_cache_hit_is_identical_object():
    ds = SampleCache(_ds(n=4))
    a = ds[1]
    assert ds[1] is a
    fresh = _ds(n=4)[1]
    for k, v in fresh.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, a[k])


def test_cache_byte_bound():
    base = _ds(n=6)
    one = sum(v.nbytes for v in base[0].values() if isinstance(v, np.ndarray))
    ds = SampleCache(base, max_bytes=int(one * 2.5))
    for i in range(6):
        ds[i]
    assert ds.cached_count == 2
    assert ds.cached_bytes <= one * 2.5
    np.testing.assert_array_equal(ds[5]["lb_img_u8"], base[5]["lb_img_u8"])


def test_cache_refuses_train_augmentation(tmp_path):
    from crog_tpu_torch.data.ocid_grasp import OCIDGraspDataset
    from tests.ocid_fixture import build_ocid_tree

    build_ocid_tree(tmp_path)
    train = OCIDGraspDataset(str(tmp_path), "training_0", img_size=128)
    with pytest.raises(ValueError, match="augmentation"):
        SampleCache(train)
    SampleCache(train, force=True)
    SampleCache(OCIDGraspDataset(str(tmp_path), "validation_0", img_size=128))


def test_cache_pickles_empty():
    ds = SampleCache(_ds(n=4))
    ds[0]
    clone = pickle.loads(pickle.dumps(ds))
    assert clone.cached_count == 0 and ds.cached_count == 1
    np.testing.assert_array_equal(clone[0]["lb_img_u8"], ds[0]["lb_img_u8"])
    assert clone.max_ori_size == (60, 80)  # the dataset's attributes pass through


def test_cache_through_loader_two_epochs():
    ds = SampleCache(_ds(n=8))
    with DataLoader(ds, 4, shuffle=True, drop_last=True, num_workers=2) as loader:
        first = list(loader)
        assert ds.cached_count == 8
        loader.set_epoch(1)
        second = list(loader)
    assert ds.cached_count == 8
    assert len(first) == len(second) == 2
    by_id = {i: s for b in first for i, s in zip(b["sent_id"], b["lb_img_u8"])}
    for b in second:
        for i, img in zip(b["sent_id"], b["lb_img_u8"]):
            np.testing.assert_array_equal(img, by_id[i])


def test_cache_under_thread_contention():
    """32 threads hammer 8 indices with a short switch interval: every
    index is cached once, the byte count is the sum of the cached samples',
    and every read returns the cached object."""
    ds = SampleCache(_ds(n=8))
    seen = [[] for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda t=t: [
            seen[i].append(ds[i]) for i in (np.arange(40) * (t + 1)) % 8])
            for t in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert ds.cached_count == 8
    from crog_tpu_torch.data.cache import _sample_nbytes

    assert ds.cached_bytes == sum(_sample_nbytes(ds[i]) for i in range(8))
    for i in range(8):
        assert any(s is ds[i] for s in seen[i])
