"""The TSDF step's stage and counter metrics on the tiny CPU cell: the two
counter metrics read the program's recording of the traced window, the
three stage device times read nothing on the CPU (it has no GPU-side
annotations), and a run without a trace records nothing."""

from voxblox_tpu_torch.utils import timing

from mapbench import harness

from .tiny import make_root, run, small_windows

STAGES = [f"integrate.{s}.device_ms_per_scan" for s in
          ("bundle", "allocate", "walk")]


def test_traced_run_reads_the_program_counters(tmp_path, monkeypatch):
    small_windows(monkeypatch)
    root = make_root(str(tmp_path))
    res, _ = run(root, trace=True)
    m = res["metrics"]
    share = m["integrate.walk_useful_share"]["value"]
    probes = m["integrate.hash_probes_per_scan"]["value"]
    assert 0.0 < share < 100.0
    assert probes > 0
    assert not set(STAGES) & set(m)
    # The recording covers the traced scans and nothing else.
    scans = {r["scan"] for r in timing.summary()["records"]
             if r["tag"] == "integrate/merged"}
    assert len(scans) == harness.TRACE_SCANS


def test_untraced_run_records_nothing(tmp_path, monkeypatch):
    small_windows(monkeypatch)
    timing.stop_recording()

    def refuse():
        raise AssertionError("a --trace 0 run started a recording")

    monkeypatch.setattr(timing, "start_recording", refuse)
    root = make_root(str(tmp_path))
    res, _ = run(root, trace=False)
    assert res["attempted"] > 0
    assert timing.summary() == {"spans": {}, "counters": {}, "records": []}
