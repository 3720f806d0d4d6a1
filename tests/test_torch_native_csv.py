"""The port's native CSV writer against its Python renderer and the JAX
package's writer, byte for byte.

``csrc/csv_writer.cpp`` (built by ``utils/native.py`` with g++ at first
use) renders ``cluster_log.csv`` and ``job_log.csv`` rows with the printf
formats of the Python renderer (``sim/io.py::CSVWriters(plain=True)``).
Rows come from a numpy seed, with edge values spliced in: ``-0.0``, values
whose decimal expansion sits on or beside a rounding boundary of their
column's format, tiny negatives that round to ``-0.0...``, and powers and
energies in the 1e5-1e9 range.  Each row set is written four ways (the
port's native writer, the port's Python renderer, the JAX package's
``CSVWriters`` on its native path and on its Python path) and the files
must be equal byte for byte.  A failed build raises; it never falls back.
"""

import os

import numpy as np
import pytest

from distributed_cluster_gpus_tpu.configs import build_fleet as jax_build_fleet
from distributed_cluster_gpus_tpu.sim.io import CSVWriters as JaxWriters
from distributed_cluster_gpus_tpu_torch.configs.paper import (
    build_duo_fleet, build_fleet)
from distributed_cluster_gpus_tpu_torch.sim import io as tio
from distributed_cluster_gpus_tpu_torch.utils import native

# values on and beside the rounding boundaries of %.2f / %.3f / %.4f /
# %.6f, negative zeros and tiny negatives
EDGES = np.array([-0.0, 0.0, 0.125, 0.0625, 0.005, 0.015, 0.0005, 0.00005,
                  2.675, 1.0005, 0.9999995, 123.4565, -0.00001, -0.004,
                  1e-7, -1e-7, 0.5, 1.5, 2.5, 99.995],
                 np.float32)
BIG = np.array([1.0e5, 1.234567e6, 7.5e8, 3.3554432e7, 9.99999e8, 2.5e9],
               np.float32)


def _cluster_rows(rng, n_ticks, n_dc):
    rows = rng.random((n_ticks, n_dc, 14)).astype(np.float32)
    rows[..., 0] = np.cumsum(rng.random(n_ticks)[:, None] * 20.0, axis=0)
    for col in range(2, 9):  # the integer-rendered columns
        rows[..., col] = rng.integers(0, 1489, (n_ticks, n_dc))
    rows[..., 12] *= 2.0e5  # power_W
    rows[..., 13] *= 5.0e6  # energy_kJ over a long run
    flat = rows.reshape(-1, 14)
    for col in (0, 1, 9, 10, 11, 12, 13):  # every float column
        k = min(len(EDGES), len(flat))
        flat[:k, col] = rng.permutation(EDGES)[:k]
        flat[-len(BIG):, col] = BIG
    return rows


def _job_rows(rng, n, n_ing, n_dc):
    rows = rng.random((n, 15)).astype(np.float32)
    rows[:, 0] = np.arange(1, n + 1)
    rows[:, 1] = rng.integers(0, n_ing, n)
    rows[:, 2] = rng.integers(0, 2, n)
    rows[:, 4] = rng.integers(0, n_dc, n)
    rows[:, 6] = rng.integers(1, 129, n)
    rows[:, 11] = rng.integers(0, 4, n)
    rows[:, 8] *= 6.048e5  # start_s over a week
    rows[:, 10] *= 50.0
    rows[:, 9] = rows[:, 8] + rows[:, 10]
    rows[:, 13] *= 3.0e5  # P_pred
    rows[:, 14] *= 4.0e8  # E_pred
    for col in (3, 5, 7, 8, 9, 10, 12, 13, 14):
        rows[:len(EDGES), col] = rng.permutation(EDGES)
        rows[-len(BIG):, col] = BIG
    return rows


def _write_four(tmp_path, fleet, jax_fleet, kind, rows, idxs):
    outs = {}
    for name, make in (
            ("native", lambda d: tio.CSVWriters(d, fleet)),
            ("plain", lambda d: tio.CSVWriters(d, fleet, plain=True)),
            ("jax_native", lambda d: JaxWriters(d, jax_fleet)),
            ("jax_python", lambda d: JaxWriters(d, jax_fleet,
                                                use_native=False))):
        d = str(tmp_path / name)
        w = make(d)
        if name == "jax_native":
            assert w._lib is not None, "the JAX package's writer did not build"
        getattr(w, f"write_{kind}_chunk")(rows, idxs)
        with open(getattr(w, f"{kind}_path"), "rb") as f:
            outs[name] = f.read()
    return outs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_rows_byte_identical(tmp_path, seed):
    rng = np.random.default_rng(seed)
    fleet, jax_fleet = build_fleet(), jax_build_fleet()
    rows = _cluster_rows(rng, 40, fleet.n_dc)
    idxs = np.sort(rng.choice(40, 25, replace=False))
    outs = _write_four(tmp_path, fleet, jax_fleet, "cluster", rows, idxs)
    assert outs["native"].count(b"\r\n") == 1 + 25 * fleet.n_dc
    assert b"-0.0000" in outs["native"] and b"-0.00," in outs["native"]
    for name in ("plain", "jax_native", "jax_python"):
        assert outs["native"] == outs[name], name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_job_rows_byte_identical(tmp_path, seed):
    rng = np.random.default_rng(100 + seed)
    fleet, jax_fleet = build_fleet(), jax_build_fleet()
    rows = _job_rows(rng, 300, fleet.n_ing, fleet.n_dc)
    idxs = np.arange(300)
    outs = _write_four(tmp_path, fleet, jax_fleet, "job", rows, idxs)
    assert outs["native"].count(b"\r\n") == 301
    assert b"-0.000000" in outs["native"]
    for name in ("plain", "jax_native", "jax_python"):
        assert outs["native"] == outs[name], name


def test_appends_after_the_header_and_keeps_a_resumed_prefix(tmp_path):
    fleet = build_duo_fleet()
    rng = np.random.default_rng(7)
    rows = _job_rows(rng, 20, fleet.n_ing, fleet.n_dc)
    w = tio.CSVWriters(str(tmp_path), fleet)
    w.write_job_chunk(rows, np.arange(10))
    mark = w.offsets()
    w.write_job_chunk(rows, np.arange(10, 20))
    w.truncate_to(mark)
    w2 = tio.CSVWriters(str(tmp_path), fleet, append=True)
    w2.write_job_chunk(rows, np.arange(10, 20))
    p = tio.CSVWriters(str(tmp_path / "plain"), fleet, plain=True)
    p.write_job_chunk(rows, np.arange(20))
    assert open(w.job_path, "rb").read() == open(p.job_path, "rb").read()


def test_write_error_raises_oserror(tmp_path):
    fleet = build_duo_fleet()
    w = tio.CSVWriters(str(tmp_path), fleet)
    os.remove(w.job_path)
    os.mkdir(w.job_path)  # fopen(..., "a") on a directory fails: EISDIR
    rows = _job_rows(np.random.default_rng(3), 40, fleet.n_ing, fleet.n_dc)
    with pytest.raises(OSError) as e:
        w.write_job_chunk(rows, np.arange(4))
    assert e.value.errno is not None and e.value.filename == w.job_path


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A source that does not compile raises (no fallback) and the message
    carries the compiler's output; the good build is untouched."""
    bad = tmp_path / "csv_writer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="native CSV writer build failed"
                       ) as e:
        native.build_csv_writer()
    assert "error" in str(e.value)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="needs a C\\+\\+ compiler"):
        native.build_csv_writer()


def test_the_port_builds_its_own_copy():
    """The library comes from the port's csrc/ into build/torch_kernels/,
    never from the repo's native/ directory."""
    path = native.build_csv_writer()
    assert os.path.basename(os.path.dirname(path)) == "torch_kernels"
    assert native.SOURCE.endswith(os.path.join(
        "distributed_cluster_gpus_tpu_torch", "csrc", "csv_writer.cpp"))
    with open(native.__file__) as f:
        assert "native/" not in f.read().replace("utils/native.py", "")
