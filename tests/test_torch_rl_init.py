"""The port's initial weights against the JAX package's (CPU).

The JAX ``sac_init`` draws every Dense kernel with flax's ``lecun_normal``
(``jax.random.truncated_normal(-2, 2) * sqrt(1 / fan_in) / 0.8796...``)
from the key flax's ``LazyRng`` derives for that Dense from its module's
``init`` key and name.  The port repeats the derivation with its own
threefry (``ops/prng.py``: ``truncated_normal``, ``fold_in_static``):

* the keys and the uniform draws' bits are byte-exact;
* the truncated normal's values are within ``TN_ULP`` ulp: they go through
  XLA's ``erf_inv`` polynomial, whose ``log1p`` the port's differs from by
  an ulp on some inputs (``tests/test_torch_ops.py``); the kernels, scaled
  by the float32 standard deviation, within ``INIT_ULP``;
* everything else ``sac_init`` builds (zero biases, log alpha, Adam states,
  the CMDP state, the target critic) is bitwise equal.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import LazyRng

from distributed_cluster_gpus_tpu.rl import cmdp as jcmdp
from distributed_cluster_gpus_tpu.rl import sac as jsac
from distributed_cluster_gpus_tpu.rl.agent import CHSAC_AF as JAgent
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch.ops import prng
from distributed_cluster_gpus_tpu_torch.rl import cmdp as tcmdp
from distributed_cluster_gpus_tpu_torch.rl import sac as tsac
from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF as TAgent

TN_ULP = 4
INIT_ULP = 4


def _ulps(a, b):
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(key(a) - key(b))


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("shape", [(1,), (49, 256), (256, 192), (7, 3, 5)])
@pytest.mark.parametrize("seed", [0, 2**40 + 7])
def test_truncated_normal_matches_jax(seed, shape):
    k = jax.random.key(seed)
    want = np.asarray(jax.random.truncated_normal(k, -2, 2, shape, jnp.float32))
    got = prng.truncated_normal(torch.tensor(_kd(k)), -2.0, 2.0, shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert _ulps(want, got).max() <= TN_ULP
    lo, hi = np.nextafter(np.float32(-2), 0), np.nextafter(np.float32(2), 0)
    assert got.min() >= lo and got.max() <= hi
    # the uniform's bits under the erf_inv are jax's, byte for byte
    bits = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    o0, o1 = prng._block(torch.tensor(_kd(k))[None, :],
                         torch.arange(int(np.prod(shape)), dtype=torch.int64))
    assert np.array_equal((o0 ^ o1).numpy().reshape(shape), bits)


@pytest.mark.parametrize("separator", [False, True])
@pytest.mark.parametrize("parts", [("Dense_0", 1), ("twins_1_2", 2), ("a", "bc"),
                                   (0,), (255, "x", 2**40), ()])
def test_fold_in_static_matches_flax(parts, separator):
    k = jax.random.key(77)
    old = flax.config.flax_fix_rng_separator
    flax.config.update("flax_fix_rng_separator", separator)
    try:
        want = _kd(LazyRng.create(k, *parts).as_jax_rng())
    finally:
        flax.config.update("flax_fix_rng_separator", old)
    got = prng.fold_in_static(torch.tensor(_kd(k)), parts, separator)
    assert np.array_equal(got.numpy(), want)


def _cfgs(arch, obs, n_dc, n_g, latent, n_q):
    kw = dict(obs_dim=obs, n_dc=n_dc, n_g=n_g, latent=latent, n_quantiles=n_q,
              critic_arch=arch)
    return (jsac.SACConfig(constraints=jcmdp.default_constraints(500.0), **kw),
            tsac.SACConfig(constraints=tcmdp.default_constraints(500.0), **kw))


def _assert_same_init(a, b):
    assert set(a) == set(b)
    for path, x in a.items():
        y = b[path]
        assert x.dtype == y.dtype and x.shape == y.shape, path
        if path.endswith(".kernel") and path.split(".")[0].endswith("_params"):
            assert _ulps(x, y).max() <= INIT_ULP, path
            assert np.array_equal(np.signbit(x), np.signbit(y)), path
        else:
            assert np.array_equal(x, y), path


@pytest.mark.parametrize("arch", ["onehot", "heads"])
@pytest.mark.parametrize("widths", ["small", "published"])
def test_sac_init_matches_jax(arch, widths):
    """``sac_init(cfg, key)`` leaf by leaf against the JAX ``sac_init`` of
    the same key, both critics, at small and the published widths."""
    dims = (19, 3, 4, 32, 8) if widths == "small" else (49, 8, 8, 256, 32)
    cj, ct = _cfgs(arch, *dims)
    k = jax.random.key(31)
    sj = jsac.sac_init(cj, k)
    st = tsac.sac_init(ct, torch.tensor(_kd(k)), device="cpu")
    _assert_same_init(
        dict(_leaves(bridge.flax_sac_to_numpy(jax.tree.map(np.asarray, sj)))),
        dict(_leaves(bridge.sac_to_numpy(ct, st))))


@pytest.mark.parametrize("seed", [0, 123])
def test_agent_matches_jax_weights_and_key_chain(seed):
    """``CHSAC_AF(seed=s)`` on both packages: the same initial weights (as
    above) and the same agent key chain, before and after a chunk's split."""
    kw = dict(obs_dim=13, n_dc=2, n_g_choices=4, seed=seed, buffer_capacity=64)
    aj, at = JAgent(**kw), TAgent(**kw, device="cpu")
    assert np.array_equal(at.key.numpy(), _kd(aj.key))
    _assert_same_init(
        dict(_leaves(bridge.flax_sac_to_numpy(jax.tree.map(np.asarray, aj.sac)))),
        dict(_leaves(bridge.sac_to_numpy(at.cfg, at.sac))))
    kj = jax.random.split(aj.key)
    kt = prng.split(at.key, 2)
    assert np.array_equal(kt.numpy(), np.stack([_kd(kj[0]), _kd(kj[1])]))
