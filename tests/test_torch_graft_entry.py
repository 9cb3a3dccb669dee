"""The port's graft entry points (agc_tpu_torch/graft_entry.py) on the
CPU, against agc_tpu's (__graft_entry__.py): the flagship scan step on the
same numpy inputs, equal exactly (canonical codes unflipped, validity,
membership), with the example's 256 random splitters and with a table of
4,096 drawn from the rows' own canonical codes; and the multi-device dry
run at 2 and 4 CPU devices (spawned gloo ranks for the exchange).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as tpu_graft
from agc_tpu_torch import graft_entry
from agc_tpu_torch.ops import u64


def _own_table(chunks, n: int = 4096) -> np.ndarray:
    """n sorted splitters drawn from the rows' own valid canonical codes."""
    canon, valid, _member = graft_entry.entry("cpu")[0](chunks, np.zeros(1, np.uint64))
    codes = np.unique(u64.to_u64(canon[valid]))
    return np.sort(np.random.default_rng(1).choice(codes, n, replace=False))


@pytest.mark.parametrize("table", ["example", "own codes"])
def test_entry_matches_agc_tpu(table):
    fn, (chunks, splitters) = graft_entry.entry("cpu")
    tpu_fn, (tpu_chunks, tpu_splitters) = tpu_graft.entry()
    assert np.array_equal(np.asarray(tpu_chunks), chunks)
    assert np.array_equal(np.asarray(tpu_splitters), splitters)
    if table == "own codes":
        splitters = _own_table(chunks)
    canon, valid, member = fn(chunks, splitters)
    want = tpu_fn(jnp.asarray(chunks), jnp.asarray(splitters))
    assert canon.device.type == "cpu" and canon.dtype == torch.int64
    assert np.array_equal(u64.to_u64(canon), np.asarray(want[0]))
    assert np.array_equal(valid.numpy(), np.asarray(want[1]))
    assert np.array_equal(member.numpy(), np.asarray(want[2]))
    if table == "own codes":
        assert int(member.sum()) >= 4096


def test_entry_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multichip_cpu(n_devices):
    graft_entry.dryrun_multichip(n_devices, "cpu")


def test_dryrun_multichip_cuda_needs_the_cards():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(1)
