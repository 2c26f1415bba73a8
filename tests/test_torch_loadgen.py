"""The port's load generator (a verbatim copy of ``repro``'s, pinned by the
drift check) gives byte-identical traces to ``repro``'s for the same seeded
configs, and its replay drives the port's scheduler engine on the CPU."""

import numpy as np
import pytest

from repro.serving import loadgen as JL
from repro_torch.serving import loadgen as TL

CONFIGS = {
    "slo_smoke": dict(duration_s=2.5, base_rps=8.0, burst_factor=5.0,
                      burst_period_s=1.25, burst_duty=0.3, seed=7),
    "diurnal": dict(duration_s=6.0, base_rps=5.0, diurnal_amplitude=0.6,
                    diurnal_period_s=3.0, zipf_s=2.0, seed=11),
    "long_tail": dict(duration_s=4.0, base_rps=12.0, burst_factor=1.0,
                      suffix_len_median=20.0, suffix_len_sigma=1.2,
                      max_new_median=12.0, max_seq=48, vocab=512, seed=3),
}


def _as_bytes(trace):
    out = []
    for r in trace.requests:
        out.append((r.rid, np.float64(r.at_s).tobytes(), r.tenant, r.cls,
                    r.priority, r.sys_id, r.prompt.dtype.str,
                    r.prompt.tobytes(), r.max_new))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trace_is_byte_identical_to_repro(name):
    kw = CONFIGS[name]
    want = JL.generate_trace(JL.LoadgenConfig(**kw))
    got = TL.generate_trace(TL.LoadgenConfig(**kw))
    assert len(got.requests) >= 8
    assert _as_bytes(got) == _as_bytes(want)
    assert got.classes == want.classes
    assert {k: (t.ttft_ms, t.tpot_ms) for k, t in got.targets.items()} == \
        {k: (t.ttft_ms, t.tpot_ms) for k, t in want.targets.items()}


def test_replay_drives_the_port_engine_and_folds():
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.obs import TRACER
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = configs.get_smoke("llama3.2-1b")
    trace = TL.generate_trace(TL.LoadgenConfig(
        duration_s=0.6, base_rps=20.0, vocab=cfg.vocab, seed=5))
    eng = ServingEngine(cfg, M.init_params(0, cfg, device="cpu"),
                        n_pages=128, device="cpu",
                        scheduler=SchedulerConfig(max_slots=4, page_size=8,
                                                  max_seq=64))
    TRACER.clear()
    TRACER.enable()
    try:
        eng.start()
        reqs = TL.replay(eng, trace, speed=4.0, timeout_s=300.0)
        eng.stop()
        events = TRACER.snapshot()
    finally:
        TRACER.disable()
    assert [len(r.out) for r in reqs] == [t.max_new for t in trace.requests]
    report = TL.fold_report(trace, events=events,
                            pool_stats=eng.kv_pool.stats(),
                            pages_saved=eng.stats.pages_saved)
    assert report.overall["requests"] == len(trace.requests)
    assert set(report.to_dict()["per_class"]) <= {"interactive", "batch"}
