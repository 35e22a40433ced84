"""The port's roofline and report (``launch/roofline.py``,
``launch/report.py``) against the reference's.

* Given one set of cost numbers and the reference's TPU constants, every
  field of the port's ``RooflineReport`` (from an ``OpCost``) equals the
  reference's (from ``tests/test_roofline.py``'s hand-written HLO
  module), derived fields and ``format_row`` included, at each
  bottleneck and with the int8 peak;
* ``HW`` defaults to the H100 SXM5 datasheet figures, cited in the
  module, and ``chip_smoke.py`` reads its bandwidth and int8 peak from
  it (its per-call bounds unchanged);
* ``report.render`` gives the same string on both sides for the same
  records, and either package's ``report.main`` prints it.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest

from repro.launch import report as jreport
from repro.launch import roofline as JRL
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as TRL
from repro_torch.launch.op_analysis import OpCost

_HLO = """\
HloModule fake_cell, num_partitions=4

ENTRY %main (p0: f32[8,4], p1: f32[4,16]) -> f32[8,16] {
  %a = f32[8,4]{1,0} parameter(0)
  %b = f32[4,16]{1,0} parameter(1)
  %ag = f32[8,4]{1,0} all-gather(%a), replica_groups=[1,4], dimensions={0}
  ROOT %out = f32[8,16]{1,0} dot(%ag, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""
FLOPS = 2 * 8 * 16 * 4
BYTES = (128 + 256 + 512) + (128 + 128)
LINK = 3 * 128
MEM = dict(argument_bytes=100, output_bytes=20, temp_bytes=3, alias_bytes=0)


class _Mem:
    argument_size_in_bytes = 100
    output_size_in_bytes = 20
    temp_size_in_bytes = 3
    alias_size_in_bytes = 0


class _Compiled:
    def as_text(self):
        return _HLO

    def cost_analysis(self):
        return {"flops": 999.0}

    def memory_analysis(self):
        return _Mem()


def _pair(hw_kw, int8=False):
    ref = JRL.roofline("fake_arch", "train", "1x4", 4, _Compiled(), 512.0,
                       hw=JRL.HW(**hw_kw), int8=int8)
    cost = OpCost(flops=FLOPS, bytes=BYTES, collective_bytes=LINK,
                  per_collective={"all-gather": LINK}, raw_flops=999.0)
    tpu = dict(peak_flops=197e12, peak_flops_int8=394e12, hbm_bw=819e9,
               link_bw=50e9)
    got = TRL.roofline("fake_arch", "train", "1x4", 4, cost, 512.0,
                       hw=TRL.HW(**dict(tpu, **hw_kw)), int8=int8,
                       memory_per_device=dict(MEM))
    return ref, got


@pytest.mark.parametrize("hw_kw,int8,expect", [
    ({}, False, "collective"), ({}, True, "collective"),
    ({"peak_flops": 1.0}, False, "compute"),
    ({"hbm_bw": 1.0}, False, "memory")])
def test_report_equals_reference(hw_kw, int8, expect):
    ref, got = _pair(hw_kw, int8)
    assert got.to_dict() == ref.to_dict()
    assert got.bottleneck == expect
    assert (got.step_time_lb, got.roofline_fraction) == (
        ref.step_time_lb, ref.roofline_fraction)
    assert TRL.format_row(got) == JRL.format_row(ref)


def test_h100_defaults_cited():
    hw = TRL.HW()
    assert (hw.peak_flops, hw.peak_flops_int8, hw.hbm_bw, hw.link_bw) == (
        989e12, 1979e12, 3.35e12, 50e9)
    with pytest.raises(dataclasses.FrozenInstanceError):
        hw.peak_flops = 1.0
    doc = TRL.__doc__
    for cite in ("datasheet", "989 TFLOP/s", "1979 TOPS", "3.35 TB/s",
                 "400 Gb/s NDR", "450 GB/s"):
        assert cite in doc, cite


def test_chip_smoke_reads_hw_constants():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    chip_smoke.load_hw()
    assert chip_smoke.HBM_BYTES_PER_S == TRL.HW().hbm_bw
    assert chip_smoke.INT8_OPS_PER_S == TRL.HW().peak_flops_int8
    # VGG-11's first conv at batch 8 (pre-padded 226 x 226 x 3, fused
    # epilogue): the bound PERF.md's table sums, as before the move
    call = dict(mkn=(8 * 224 * 224, 27, 64), x_bytes=8 * 226 * 226 * 3,
                epi=True)
    m, k, n = call["mkn"]
    old = (call["x_bytes"] + k * n + 512 + m * n + 8 * n) / 3.35e12 * 1e3
    assert chip_smoke.bound(call) == (pytest.approx(old, rel=1e-15),
                                      "bytes")


_RECORDS = [
    {"arch": "gemma_2b", "cell": "train_4k", "mesh": "16x16",
     "status": "ok", "t_compute": 1.3397, "t_memory": 2.98, "t_collective":
     0.0029, "bottleneck": "memory", "useful_ratio": 0.0461,
     "roofline_fraction": 0.449,
     "memory_per_device": {"argument_bytes": 2 ** 24, "temp_bytes": 2 ** 33,
                           "output_bytes": 0, "alias_bytes": 0}},
    {"arch": "kimi_k2_1t_a32b", "cell": "decode_32k", "mesh": "2x16x16",
     "status": "ok", "t_compute": 0.00008, "t_memory": None,
     "t_collective": 12.5, "bottleneck": "collective", "useful_ratio": 0.03,
     "roofline_fraction": 0.0, "memory_per_device": None},
    {"arch": "whisper_medium", "cell": "prefill_32k", "mesh": "16x16",
     "status": "fail", "error": "RuntimeError: " + "x" * 100},
]


def test_render_equals_reference(tmp_path, capsys):
    assert treport.render(_RECORDS) == jreport.render(_RECORDS)
    path = tmp_path / "r.json"
    path.write_text(json.dumps(_RECORDS))
    argv = sys.argv
    try:
        sys.argv = ["report", str(path)]
        treport.main()
        got = capsys.readouterr().out
        jreport.main()
        want = capsys.readouterr().out
    finally:
        sys.argv = argv
    assert got == want == jreport.render(_RECORDS) + "\n"
