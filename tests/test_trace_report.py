"""The trace-to-metrics reduction of tools/trace_report.py."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import trace_report as tr  # noqa: E402

_HLO = '''
  %loop_xor_fusion.3 = u8[2,360]{1,0} fusion(%p), kind=kLoop, calls=%f.3, metadata={op_name="jit(<unknown>)/fec/ldpc/xor" stack_frame_id=4}
  %gemm_fusion_dot_general.2 = s32[2,192]{1,0} fusion(%a), kind=kCustom, metadata={op_name="jit(<unknown>)/fec/dot_general"}
  %fft.0.0 = c64[2,7,4096]{2,1,0} fft(%g), fft_type=IFFT, metadata={op_name="jit(<unknown>)/ofdm/jit(ifft)/fft"}
  ROOT %input_concatenate_fusion = f32[2,31616,2]{2,1,0} fusion(%fft.0.0), kind=kInput, metadata={op_name="jit(<unknown>)/iq_out/concatenate"}
  %input_concatenate_fusion.1 = u8[2,120,720]{2,1,0} fusion(%x), kind=kInput, metadata={scheduling_name="input_concatenate_fusion.1"}
'''


def test_hlo_scopes_take_the_innermost_stage():
    assert tr.hlo_scopes(_HLO) == {
        "loop_xor_fusion.3": "ldpc",
        "gemm_fusion_dot_general.2": "fec",
        "fft.0.0": "ofdm",
        "input_concatenate_fusion": "iq_out",
    }


def test_stage_times_sum_events_and_keep_unscoped_ops():
    events = [("loop_xor_fusion.3", 0, 5), ("fft.0.0", 5, 10),
              ("loop_xor_fusion.3", 20, 5), ("input_concatenate_fusion.1",
                                             30, 2)]
    agg = tr.stage_times(events, tr.hlo_scopes(_HLO))
    assert agg == {"ldpc": 10, "ofdm": 10, "other": 2}


def test_busy_time_is_the_union_of_intervals():
    events = [("a", 0, 10), ("b", 5, 10), ("c", 20, 5), ("d", 21, 1)]
    assert tr.busy_ns(events) == 20
    assert tr.busy_ns([]) == 0


_XSPACE = '''
planes {
  id: 1 name: "/device:GPU:0"
  lines {
    id: 1 name: "Stream #13(compute)" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 5000000
             stats { metadata_id: 7 str_value: "loop_xor_fusion.3" } }
    events { metadata_id: 2 offset_ps: 6000000 duration_ps: 2000000 }
  }
  lines {
    id: 2 name: "XLA Ops" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 5000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "loop_xor_fusion_3_kernel" } }
  event_metadata { key: 2 value { id: 2 name: "fft.0.0" } }
  stat_metadata { key: 7 value { id: 7 name: "hlo_op" } }
}
planes {
  id: 2 name: "/host:CPU"
  lines { id: 1 name: "python" events { metadata_id: 1 duration_ps: 9 } }
  event_metadata { key: 1 value { id: 1 name: "host_op" } }
}
'''


def test_device_events_read_gpu_stream_lines_only(tmp_path):
    """GPU stream lines only (not the derived "XLA Ops" line, not host
    planes), named by the hlo_op stat where there is one."""
    from jax.profiler import ProfileData

    path = tmp_path / "t.xplane.pb"
    path.write_bytes(ProfileData.text_proto_to_serialized_xspace(_XSPACE))
    assert tr.device_events(str(path)) == [
        ("loop_xor_fusion.3", 1000.0, 5000.0), ("fft.0.0", 7000.0, 2000.0)]
