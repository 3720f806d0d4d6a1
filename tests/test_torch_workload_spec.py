"""The port's workload specs, JSON documents and presets vs the JAX package's.

Pure numpy on both sides: every array a spec carries (times, sizes, rates,
price, carbon), every scalar and ``mean_rate`` must be equal (exactly),
for hand-built specs, JSON documents in both stream forms (the broadcast
pair and the per-ingress list, with ingress names resolved against the
fleet) and the three presets; every error the reference raises is raised
by the port with the same text.  The compiled signal timelines sample the
same values.  Tolerance: none.
"""

import json

import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu import workload as jw
from distributed_cluster_gpus_tpu.configs import build_fleet as jfleet
from distributed_cluster_gpus_tpu.models import SimParams as JParams
from distributed_cluster_gpus_tpu_torch import bridge
from distributed_cluster_gpus_tpu_torch import workload as tw
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams

FJ = jfleet()
FT = bridge.fleet_from_numpy(FJ)


def _arrays_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def same_stream(a, b):
    for f in ("kind", "rate", "amp", "period", "phase_s", "bin_s", "periodic"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("times", "sizes", "rates"):
        assert _arrays_equal(getattr(a, f), getattr(b, f)), f
    assert a.mean_rate() == b.mean_rate()


def same_spec(a, b, n_ing):
    assert a.name == b.name
    for pa, pb in zip(a.resolve(n_ing), b.resolve(n_ing)):
        for sa, sb in zip(pa, pb):
            same_stream(sa, sb)
    assert a.mean_rate(n_ing) == b.mean_rate(n_ing)
    if a.signals is None:
        assert b.signals is None
        return
    for f in ("bin_s", "periodic", "observe"):
        assert getattr(a.signals, f) == getattr(b.signals, f), f
    for f in ("price", "carbon"):
        assert _arrays_equal(getattr(a.signals, f), getattr(b.signals, f)), f


DOC_PAIR = {
    "name": "pair",
    "streams": {
        "inference": {"kind": "trace", "times": [0.5, 0.7, 2.0, 2.0, 9.25],
                      "sizes": [1, 2, 3, 4, 5]},
        "training": {"kind": "rate_timeline", "rates": [0.1, 0.0, 0.3],
                     "bin_s": 600, "periodic": True}},
    "signals": {"price": [0.1, 0.2], "carbon": [[1.0] * 8, [2.0] * 8],
                "bin_s": 1800, "periodic": False, "observe": True},
}
DOC_LIST = {
    "streams": [
        {"ingress": "us-west-gw", "inference": {"kind": "poisson", "rate": 2.0}},
        {"ingress": 3, "training": {"kind": "sinusoid", "rate": 1.0,
                                    "amp": 1.5, "period": 60, "phase_s": 7.0}},
        {"inference": {"kind": "trace", "times": [3.0]}},
    ],
    "signals": {"carbon": list(range(8))},
}


@pytest.mark.parametrize("doc", [DOC_PAIR, DOC_LIST], ids=["pair", "list"])
def test_json_documents_equal(doc, tmp_path):
    path = tmp_path / "spec.json"
    d = json.loads(json.dumps(doc))
    if isinstance(d["streams"], list):  # names resolve against a fleet
        d["streams"][0]["ingress"] = FJ.ingress_names[0]
    path.write_text(json.dumps(d))
    sj = jw.load_workload_json(str(path), FJ)
    st = tw.load_workload_json(str(path), FT)
    same_spec(sj, st, FJ.n_ing)
    # the signal timelines compile to the same values
    cj = jw.compile_signals(sj.signals, FJ)
    ct = tw.compile_signals(st.signals, FT, "cpu")
    assert np.asarray(cj.price).tobytes() == ct.price.numpy().tobytes()
    assert np.asarray(cj.carbon).tobytes() == ct.carbon.numpy().tobytes()
    for f in ("price_bin_s", "carbon_bin_s", "price_periodic",
              "carbon_periodic", "observe"):
        assert getattr(cj, f) == getattr(ct, f), f


@pytest.mark.parametrize("observe", [False, True])
@pytest.mark.parametrize("name", sorted(tw.PRESETS))
def test_presets_equal(name, observe):
    kw = {"observe": observe}
    if name == "legacy_signals":
        sj = jw.make_preset(name, FJ, params=JParams(inf_rate=3.5), **kw)
        st = tw.make_preset(name, FT, params=SimParams(inf_rate=3.5), **kw)
    else:
        sj, st = jw.make_preset(name, FJ, **kw), tw.make_preset(name, FT, **kw)
    same_spec(sj, st, FJ.n_ing)
    assert sorted(jw.PRESETS) == sorted(tw.PRESETS)


def test_legacy_signals_sample_the_static_tables():
    sig = tw.legacy_signals(FT, device="cpu")
    for t, h in ((0.0, 0), (3599.99, 0), (3600.0, 1), (86399.0, 23),
                 (86400.0 + 7200.5, 2)):
        tt = torch.tensor(t, dtype=torch.float64)
        assert float(sig.price_at(tt)) == float(np.float32(FT.price_hourly[h]))
        assert sig.carbon_at(tt).numpy().tobytes() == \
            np.asarray(FT.carbon, np.float32).tobytes()


def _errors(mod, fleet, tmp_path):
    """Every error of the spec layer, as (label, exception type, text)."""
    S, W = mod.StreamSpec, mod.WorkloadSpec
    cases = {
        "kind": lambda: S(kind="bogus"),
        "trace": lambda: S(kind="trace"),
        "timeline": lambda: S(kind="rate_timeline"),
        "signal": lambda: mod.SignalSpec(),
        "pairs": lambda: W(streams=((S(), S()),) * 3, name="w").resolve(2),
        "pair_len": lambda: W(streams=((S(),), (S(), S())), name="w").resolve(2),
        "top": lambda: mod.workload_from_dict({"streams": {}, "x": 1}),
        "no_streams": lambda: mod.workload_from_dict({"name": "a"}),
        "section": lambda: mod.workload_from_dict(
            {"streams": {"inference": {}, "trainng": {}}}),
        "stream_key": lambda: mod.workload_from_dict(
            {"streams": {"inference": {"kind": "poisson", "rat": 1}}}),
        "list_no_n": lambda: mod.workload_from_dict({"streams": [{}]}),
        "entry_key": lambda: mod.workload_from_dict(
            {"streams": [{"ingres": 0}]}, n_ing=2),
        "entry_idx": lambda: mod.workload_from_dict(
            {"streams": [{"ingress": 5}]}, n_ing=2),
        "entry_dup": lambda: mod.workload_from_dict(
            {"streams": [{"ingress": 1}, {"ingress": 1}]}, n_ing=2),
        "signal_key": lambda: mod.workload_from_dict(
            {"streams": {}, "signals": {"price": [1], "bins": 3}}),
        "preset": lambda: mod.make_preset("nope", fleet),
    }
    path = tmp_path / "names.json"
    path.write_text(json.dumps({"streams": [{"ingress": "mars"}]}))
    cases["ingress_name"] = lambda: mod.load_workload_json(str(path), fleet)
    out = {}
    for label, fn in cases.items():
        with pytest.raises(Exception) as e:
            fn()
        out[label] = (type(e.value).__name__, str(e.value))
    return out


def test_every_error_has_the_reference_text(tmp_path):
    assert _errors(tw, FT, tmp_path) == _errors(jw, FJ, tmp_path)


def test_compiler_errors_have_the_reference_text():
    from distributed_cluster_gpus_tpu.workload.compiler import WorkloadProgram as JW
    from distributed_cluster_gpus_tpu_torch.workload.compiler import WorkloadProgram as TW

    bad = {
        "order": dict(kind="trace", times=np.array([1.0, 0.5])),
        "sizes": dict(kind="trace", times=np.array([1.0, 2.0]),
                      sizes=np.array([1.0])),
        "negative": dict(kind="rate_timeline", rates=np.array([1.0, -1.0])),
        "empty": dict(kind="rate_timeline", rates=np.array([])),
        "silent": dict(kind="rate_timeline", rates=np.array([0.0, 0.0]),
                       periodic=True),
    }
    from distributed_cluster_gpus_tpu.configs import build_duo_fleet

    fj = build_duo_fleet()
    ft = bridge.fleet_from_numpy(fj)
    for label, kw in bad.items():
        texts = []
        for mod, prog, fleet, P, kwp in (
                (jw, JW, fj, JParams, {}), (tw, TW, ft, SimParams,
                                            {"device": "cpu"})):
            spec = mod.WorkloadSpec(streams=(mod.StreamSpec(**kw),
                                             mod.StreamSpec()))
            with pytest.raises(ValueError) as e:
                prog(fleet, P(workload=spec), spec, **kwp)
            texts.append(str(e.value))
        assert texts[0] == texts[1], label
    # a carbon timeline of the wrong width
    sig = dict(carbon=np.ones((2, 3)))
    with pytest.raises(ValueError) as ej:
        jw.compile_signals(jw.SignalSpec(**sig), fj)
    with pytest.raises(ValueError) as et:
        tw.compile_signals(tw.SignalSpec(**sig), ft, "cpu")
    assert str(ej.value) == str(et.value)
