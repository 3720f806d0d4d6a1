"""Carry a fleet and a simulation state between the JAX package and the port.

This system's "weights" are its world (``FleetSpec``) and its state
(``SimState``).  Both packages hold them as trees of arrays with the same
field names, so the bridge works on nested dicts of numpy arrays: the JAX
side is turned into numpy by the caller (``tree_to_numpy`` with a leaf
function that unwraps PRNG keys), the port side by :func:`state_to_numpy`.
Fields the port does not carry yet (the fault, telemetry and signal
sub-states) are ignored on the way in and absent on the way out.
:func:`sac_from_flax` carries the chsac_af learner (the JAX ``SACState``:
parameters, target critic, temperature, optimizer and CMDP states) across,
and :func:`sac_to_numpy` / :func:`flax_sac_to_numpy` put either side's in
one nested-dict layout, flax's, for leaf-by-leaf comparison;
:func:`sac_from_numpy` reads that layout back.  :func:`replay_to_numpy` /
:func:`replay_from_numpy` do the same for the replay ring in the JAX
``ReplayState`` layout.  These trees are what a checkpoint holds
(``utils/checkpoint.py``).

PRNG keys travel as their two uint32 threefry words; the port holds them in
int64 tensors (``ops/prng.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from .device import resolve_device
from .models.structs import (DCArrays, FleetSpec, JobSlab, LatWindow,
                             QueueRings, SignalState, SimState)
from .ops import prng
from .ops.bandit import BanditState
from .ops.physics import LatencyCoeffs, PowerCoeffs
from .rl.nets import dense_layers, flax_names

_KEY_FIELDS = ("key", "arr_key")


def tree_to_numpy(obj, leaf: Callable = np.asarray):
    """A dataclass tree (either package's state, or a dict of arrays such as
    an emission) as nested dicts of numpy arrays; ``None`` members are
    dropped, ``leaf`` converts each array."""
    if isinstance(obj, dict):
        return {k: tree_to_numpy(v, leaf) for k, v in obj.items()
                if v is not None}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is not None:
                out[f.name] = tree_to_numpy(v, leaf)
        return out
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return {k: tree_to_numpy(v, leaf) for k, v in zip(obj._fields, obj)}
    return leaf(obj)


def tensor_leaf(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def state_to_numpy(state: SimState) -> Dict:
    """The port's state as nested dicts of numpy (keys as uint32 words)."""
    tree = tree_to_numpy(state, tensor_leaf)
    for k in _KEY_FIELDS:
        tree[k] = tree[k].astype(np.uint32)
    return tree


def _build(cls, tree, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = tree[f.name]
        kw[f.name] = torch.tensor(np.array(v), device=device)
    return cls(**kw)


def state_from_numpy(tree: Dict, device="cuda") -> SimState:
    """A port SimState on ``device`` (the card unless the caller asks for
    the CPU) from nested dicts of numpy arrays.  A tree whose leaves carry a
    leading lane axis (a JAX ``vmap``-ed state) gives a lane-stacked state.
    A tree without ``signals`` (a run without signal timelines) gives a
    state whose ``signals`` is None."""
    device = resolve_device(device)
    nested = {"dc": DCArrays, "jobs": JobSlab, "lat": LatWindow,
              "queues": QueueRings, "bandit": BanditState,
              "signals": SignalState}
    kw = {}
    for f in dataclasses.fields(SimState):
        if f.name == "signals" and tree.get("signals") is None:
            kw[f.name] = None
            continue
        v = tree[f.name]
        if f.name in nested:
            kw[f.name] = _build(nested[f.name], v, device)
        elif f.name in _KEY_FIELDS:
            kw[f.name] = torch.tensor(np.asarray(v, np.uint32).astype(np.int64),
                                      device=device)
        else:
            kw[f.name] = torch.tensor(np.array(v), device=device)
    return SimState(**kw)


def tree_lane(tree: Dict, r: int) -> Dict:
    """Lane ``r`` of a nested-dict tree whose leaves carry a lane axis."""
    if isinstance(tree, dict):
        return {k: tree_lane(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


_OPT_GROUPS = (("enc_opt", "enc"), ("actor_opt", "actor"),
               ("critic_opt", "critic"), ("alpha_opt", "alpha"))


def _adam_state(opt):
    """optax's ScaleByAdamState inside a chain's nested state tuple (the
    first member with ``count``, ``mu`` and ``nu``)."""
    if all(hasattr(opt, k) for k in ("count", "mu", "nu")):
        return opt
    if isinstance(opt, tuple):
        for member in opt:
            found = _adam_state(member)
            if found is not None:
                return found
    return None


def _group_module(sac, group):
    return {"enc": sac.enc, "actor": sac.actor, "critic": sac.critic,
            "target": sac.target_critic}[group]


def _layer_names(sac, group):
    """flax's names of a group's Dense layers, in the port's layer order."""
    return flax_names(_group_module(sac, group))


def _group_layers(sac, group):
    return dense_layers(_group_module(sac, group))


def _flat_np(tree, names):
    """A flax params tree ({"params": {name: {kernel, bias}}}) as the flat
    buffer the port keeps (each layer's kernel, then its bias)."""
    p = tree["params"]
    if sorted(p) != sorted(names):
        raise ValueError(f"flax tree {sorted(p)} does not match the port's "
                         f"layers {names}")
    return np.concatenate([np.asarray(p[n][k], np.float32).reshape(-1)
                           for n in names for k in ("kernel", "bias")])


def _tree_np(flat, layers, names):
    """The inverse of :func:`_flat_np` for the port's ``layers`` shapes."""
    out, off = {}, 0
    for name, layer in zip(names, layers):
        entry = {}
        for k in ("kernel", "bias"):
            shape = tuple(getattr(layer, k).shape)
            n = int(np.prod(shape))
            entry[k] = flat[off:off + n].reshape(shape)
            off += n
        out[name] = entry
    return {"params": out}


def sac_from_flax(cfg, src, device="cuda"):
    """The port's whole learner (an ``rl.sac.SACState`` on ``device``, the
    card unless the caller asks for the CPU) holding the JAX package's
    ``SACState`` ``src`` with numpy leaves (``jax.tree.map(np.asarray,
    sac)``): the encoder, actor, critic and target critic parameters (flax's
    ``Dense_k`` names, ``twins_i_j`` for the heads critic), ``log_alpha``,
    optax's ``(EmptyState, ScaleByAdamState(count, mu, nu))`` of each group,
    the CMDP state and the step.  Flax's layout is the port's, so each
    array is copied as it is."""
    from .rl.optim import AdamState
    from .rl.sac import CMDPState, assemble, sac_init

    proto = sac_init(cfg, prng.key(0, "cpu"), "cpu")
    trees = {"enc": src.enc_params, "actor": src.actor_params,
             "critic": src.critic_params, "target": src.target_critic_params}
    for group, tree in trees.items():
        vals = _flat_np(tree, _layer_names(proto, group))
        flat = proto.flat[group]
        if vals.shape != tuple(flat.shape):
            raise ValueError(f"{group}: {vals.size} parameters vs the port's "
                             f"{flat.numel()}")
        with torch.no_grad():
            flat.copy_(torch.from_numpy(vals))
    dev = resolve_device(device)

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    opts = {}
    for attr, group in _OPT_GROUPS:
        adam = _adam_state(getattr(src, attr))
        if group == "alpha":
            mu, nu = (np.asarray(x, np.float32).reshape(1) for x in (adam.mu, adam.nu))
        else:
            names = _layer_names(proto, group)
            mu, nu = _flat_np(adam.mu, names), _flat_np(adam.nu, names)
        opts[group] = AdamState(count=t(adam.count, torch.int32), mu=t(mu),
                                nu=t(nu))
    cmdp = CMDPState(lam=t(src.cmdp.lam), integral=t(src.cmdp.integral),
                     prev_err=t(src.cmdp.prev_err))
    return assemble(cfg, proto.enc, proto.actor, proto.critic,
                    proto.target_critic, t(src.log_alpha), dev, opts=opts,
                    cmdp=cmdp, step=int(np.asarray(src.step)))


def sac_to_numpy(cfg, sac, leaf: Callable = tensor_leaf):
    """The port's SACState as nested dicts of numpy in flax's layout:
    ``{enc,actor,critic,target_critic}_params`` ({"params": {name: {kernel,
    bias}}}), ``log_alpha``, ``{enc,actor,critic,alpha}_opt`` ({count, mu,
    nu}), ``cmdp`` ({lam, integral, prev_err}) and ``step`` (int32).
    ``leaf`` turns each tensor into its array (a host copy by default)."""
    out = {}
    for key, group in (("enc_params", "enc"), ("actor_params", "actor"),
                       ("critic_params", "critic"),
                       ("target_critic_params", "target")):
        names = _layer_names(sac, group)
        out[key] = _tree_np(leaf(sac.flat[group]), _group_layers(sac, group),
                            names)
    out["log_alpha"] = leaf(sac.log_alpha)
    for attr, group in _OPT_GROUPS:
        st = getattr(sac, attr)
        if group == "alpha":
            mu, nu = leaf(st.mu).reshape(()), leaf(st.nu).reshape(())
        else:
            layers, names = _group_layers(sac, group), _layer_names(sac, group)
            mu = _tree_np(leaf(st.mu), layers, names)
            nu = _tree_np(leaf(st.nu), layers, names)
        out[attr] = {"count": leaf(st.count), "mu": mu, "nu": nu}
    out["cmdp"] = {k: leaf(getattr(sac.cmdp, k))
                   for k in ("lam", "integral", "prev_err")}
    out["step"] = np.asarray(sac.step, np.int32)
    return out


def sac_from_numpy(cfg, tree, device="cuda"):
    """The inverse of :func:`sac_to_numpy`: the port's whole learner on
    ``device`` from a tree in flax's layout (a port checkpoint's ``sac``
    tree, or :func:`flax_sac_to_numpy` of the JAX package's state).  The
    bf16 shadows are filled from the float32 masters (B5g's kernel on the
    card), so the first update after a restore reads what an uninterrupted
    one would."""
    from types import SimpleNamespace

    src = SimpleNamespace(
        **{k: tree[k] for k in ("enc_params", "actor_params", "critic_params",
                                "target_critic_params", "log_alpha", "step")},
        cmdp=SimpleNamespace(**tree["cmdp"]),
        **{attr: SimpleNamespace(**tree[attr]) for attr, _ in _OPT_GROUPS})
    return sac_from_flax(cfg, src, device)


def replay_to_numpy(rb) -> Dict:
    """The port's replay ring as a dict of numpy arrays in the JAX
    package's ``ReplayState`` layout (the row leaves, ``valid``, ``ptr``,
    ``size``, ``n_seen``)."""
    return tree_to_numpy(rb, tensor_leaf)


def replay_from_numpy(tree: Dict, device="cuda"):
    """A port ``ReplayState`` on ``device`` from :func:`replay_to_numpy`'s
    layout (or the JAX package's ``ReplayState`` as numpy)."""
    from .rl.replay import ReplayState

    return _build(ReplayState, tree, resolve_device(device))


def flax_sac_to_numpy(src):
    """The JAX package's SACState (numpy leaves) in :func:`sac_to_numpy`'s
    layout."""
    out = {k: tree_to_numpy(getattr(src, k)) for k in (
        "enc_params", "actor_params", "critic_params", "target_critic_params")}
    out["log_alpha"] = np.asarray(src.log_alpha)
    for attr, _ in _OPT_GROUPS:
        adam = _adam_state(getattr(src, attr))
        out[attr] = {"count": np.asarray(adam.count),
                     "mu": tree_to_numpy(adam.mu), "nu": tree_to_numpy(adam.nu)}
    out["cmdp"] = {k: np.asarray(getattr(src.cmdp, k))
                   for k in ("lam", "integral", "prev_err")}
    out["step"] = np.asarray(src.step, np.int32)
    return out


def fleet_from_numpy(src) -> FleetSpec:
    """A port FleetSpec from the JAX package's FleetSpec (or any object or
    dict with the same members, arrays as numpy)."""
    get = (src.__getitem__ if isinstance(src, dict)
           else lambda name: getattr(src, name))
    kw = {}
    for f in dataclasses.fields(FleetSpec):
        v = get(f.name)
        if f.name == "power":
            v = PowerCoeffs(*(np.asarray(a) for a in v))
        elif f.name == "latency":
            v = LatencyCoeffs(*(np.asarray(a) for a in v))
        elif isinstance(v, (tuple, int, str)):
            v = v
        else:
            v = np.asarray(v)
        kw[f.name] = v
    return FleetSpec(**kw)


def tree_mismatches(a: Dict, b: Dict, path: str = "") -> List[str]:
    """Paths of leaves that differ BITWISE between two nested-dict trees
    (dtype, shape and every bit; keys present in either tree count).
    Modelled on the JAX package's test comparator, but stricter: -0.0 and
    +0.0 differ here."""
    bad = []
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)):
            return [path or "."]
        for k in sorted(set(a) | set(b)):
            p = f"{path}.{k}" if path else k
            if k not in a or k not in b:
                bad.append(p)
            else:
                bad.extend(tree_mismatches(a[k], b[k], p))
        return bad
    x, y = np.asarray(a), np.asarray(b)
    if x.dtype != y.dtype or x.shape != y.shape:
        return [f"{path} ({x.dtype}{list(x.shape)} vs {y.dtype}{list(y.shape)})"]
    if x.tobytes() != y.tobytes():
        return [path]
    return bad


#: the bounds the update's parity tests hold a chunk of updates to
#: (tests/test_torch_rl_learn_update.py): metrics relative and absolute,
#: log alpha per update, Adam's moments per update (of a leaf's largest)
METRIC_RTOL, METRIC_ATOL = 2e-3, 1e-4
ALPHA_ATOL, MOMENT_RTOL = 1e-6, 0.05


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    else:
        yield path, np.asarray(tree)


def sac_far_apart(cfg, a, b, n: int, metrics=None) -> List[str]:
    """Paths where two learned states (``sac_to_numpy`` trees ``a`` and
    ``b``), each ``n`` updates from one state and one sample chain whose
    products summed in other orders, lie beyond the bounds the parity tests
    hold a chunk of updates to: every parameter within ``n * 2 * lr`` (a
    sign flip of Adam's step per update) with the median within ``n * lr /
    100``; the target within ``tau * 2 * lr`` times 1 + ... + n plus an ulp
    per update; log alpha within ``n * ALPHA_ATOL``; the moments within
    ``n * MOMENT_RTOL`` of their largest; the counts, the step and the CMDP
    state (the samples, hence the costs, are equal) bitwise; ``metrics``,
    a pair of metric dicts, within ``METRIC_RTOL`` relative or
    ``METRIC_ATOL``."""
    lr, tau = cfg.lr, cfg.tau
    a, b = dict(_leaves(a)), dict(_leaves(b))
    bad = sorted(set(a) ^ set(b))
    for path in sorted(set(a) & set(b)):
        x, y = a[path], b[path]
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(path)
            continue
        d = np.abs(x.astype(np.float64) - y.astype(np.float64))
        group = path.split(".")[0]
        if group in ("enc_params", "actor_params", "critic_params"):
            ok = d.max() <= n * 2 * lr and np.median(d) <= n * lr / 100
        elif group == "target_critic_params":
            ok = np.all(d <= n * (n + 1) // 2 * 2 * lr * tau
                        + n * np.spacing(np.abs(x)))
        elif path == "log_alpha":
            ok = d.max() <= n * ALPHA_ATOL
        elif path.endswith(".mu") or ".mu." in path or path.endswith(".nu") \
                or ".nu." in path:
            ok = d.max() <= n * MOMENT_RTOL * max(np.abs(x).max(), 1e-30)
        else:  # counts, step, the CMDP state
            ok = x.tobytes() == y.tobytes()
        if not ok:
            bad.append(path)
    for k in (metrics[0] if metrics else {}):
        x, y = (np.asarray(m[k].detach().cpu()) for m in metrics)
        if not (np.isfinite(y).all() and np.all(
                np.abs(x - y) <= METRIC_RTOL * np.abs(x) + METRIC_ATOL)):
            bad.append(f"metric {k}")
    return bad
