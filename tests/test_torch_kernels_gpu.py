"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU: a CUDA kernel has no CPU mode, so they
carry the ``gpu`` marker and skip elsewhere.  The file imports no JAX, so
it also runs on a machine that has only PyTorch (with ``--noconftest``,
since the suite's conftest imports JAX):

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest -p no:cacheprovider

``chip_smoke.py`` repeats the B2 check at the paper fleet's shape.
"""

import pytest
import torch

from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet, build_fleet
from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.sim.engine import init_state
from distributed_cluster_gpus_tpu_torch.workload.compiler import compile_workload


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _args(fleet, params, dev):
    wt = compile_workload(fleet, params, dev)
    st = init_state(params.seed, fleet, params, workload=wt, device=dev)
    S = wt.n_streams
    return (st.arr_key, st.arr_count.reshape(S), st.next_arrival.reshape(S),
            st.arr_cum.reshape(S), st.arr_epoch.reshape(S), wt.family_t,
            wt.sparams)


@pytest.mark.gpu
@pytest.mark.parametrize("fleet_fn,kw,n", [
    (build_duo_fleet, dict(), 512),
    (build_duo_fleet, dict(inf_mode="poisson", trn_mode="off"), 3000),
    (build_fleet, dict(inf_amp=1.0, inf_period=60.0), 4096),
])
def test_arrival_tables_kernel_matches_plain_version(cuda, fleet_fn, kw, n):
    """Key words and uniform draws bit-exact; sizes, next-arrival clocks
    and folds within 1e-6 relative (measured bit-identical on an H100)."""
    args = _args(fleet_fn(), SimParams(queue_cap=64, job_cap=32, seed=2, **kw), cuda)
    before = b2.arrival_tables.launches
    out = b2.arrival_tables(*args, n, with_aux=True)
    assert b2.arrival_tables.launches == before + 1
    ref = b2.arrival_tables_reference(*args, n, with_aux=True)
    torch.cuda.synchronize()
    assert torch.equal(out["aux_key"], ref["aux_key"])
    assert torch.equal(out["aux_u"], ref["aux_u"])
    for k in ("sizes", "tnext", "cum"):
        torch.testing.assert_close(out[k], ref[k], rtol=1e-6, atol=0.0)


@pytest.mark.gpu
def test_arrival_tables_wrapper_rejects_mixed_devices(cuda):
    args = list(_args(build_duo_fleet(), SimParams(queue_cap=8, job_cap=8), cuda))
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="expected"):
        b2.arrival_tables(*args, 16)
