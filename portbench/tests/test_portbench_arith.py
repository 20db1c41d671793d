"""The frozen yardstick: the bytes of a hit kernel's launch and the
reduction of a profile to busy time, idle gaps and launches."""

import types

import numpy as np

from portbench import inputs, port, roofline, trace


def test_wide_shade_bytes_of_the_slice_chunk():
    """230.9 MB for a 4,147,200-ray launch on the slice accel, as phase 3 of
    ``chip_smoke.py`` counts it."""
    cfg = {"meshes": [{"kind": "dragon_proxy", "target_tris": 139000, "seed": 7,
                       "material": 1, "translate": [0, 0, -4]}],
           "planes": [{"normal": [0, 1, 0], "offset": -1.8, "material": 2}],
           "materials": [[[0.35, 0.45, 0.65], [0, 0, 0], 0.0],
                         [[0, 0, 0], [0.75, 0.55, 0.35], 0.15],
                         [[0, 0, 0], [0.6, 0.6, 0.65], 0.0]]}
    acc, secs = port.accel(port.scene(inputs.make(cfg)), {"kind": "shaded", "leaf_size": 16})
    tables = port.table_bytes(acc, ("cboxes", "clinks", "caxis", "tris"))
    assert round(roofline.wide_shade_bytes(4147200, tables) / 1e6, 1) == 230.9
    assert secs > 0
    assert abs(roofline.bound_s(230.9e6) * 1e3 - 0.0689) < 1e-4


def test_wide_exact_bytes():
    assert roofline.wide_exact_bytes(10, 100) == 10 * 40 + 100


def test_dragon_proxy_matches_the_program():
    from atray_tpu_torch.scene import procedural

    m = procedural.dragon_proxy(target_tris=5000, material=1)
    v, f, n = inputs.dragon_proxy(5000, 7)
    assert np.array_equal(m.vertices, v) and np.array_equal(m.faces, f)
    assert np.array_equal(m.normals, n)


def _ev(name, a, b):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b))


def test_summary_of_a_profile():
    """Busy time is the union of the device intervals clipped to the
    window; a gap is named by the innermost host op open at its middle."""
    dev = [_ev("void wide_shade_kernel<4>(float*)", 10, 30),
           _ev("elementwise_kernel", 20, 40), _ev("Memcpy DtoH (Device -> Pageable)", 60, 70),
           _ev("elementwise_kernel", 90, 120)]
    host = [_ev("outer", 0, 100), _ev("aten::copy_", 45, 55)]
    s = trace.summarize(dev, host, 0.0, 100.0)
    assert s["window_s"] == 100e-6
    assert abs(s["busy_s"] - 50e-6) < 1e-12            # 10-40, 60-70, 90-100
    assert s["launches"] == 3
    assert trace.first_launches(s, "wide_shade_kernel") == (20e-6, 1)
    assert abs(trace.other_time(s) - 30e-6) < 1e-12     # the clipped elementwise kernels
    names = dict(s["idle_gaps"])
    assert abs(names["aten::copy_"] - 20e-6) < 1e-12 and abs(names["outer"] - 30e-6) < 1e-12
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "elementwise_kernel" and len(b["idle_gaps"]) <= 10


def test_port_kernels_are_read_from_the_sources():
    own = trace.port_kernels()
    assert "wide_shade_kernel" in own and "wide_exact_kernel" in own
    assert trace.kernel_of("void lane_take_kernel<3>(int)", own) == "lane_take_kernel"
    assert trace.kernel_of("at::native::vectorized_elementwise_kernel", own) is None


def test_first_launch_of_each_unit():
    """The roofline readers take the first launch of a kernel after the
    window's start and after each unit's end mark, and no other."""
    ws = "void wide_shade_kernel<4>(float*)"
    dev = [_ev(ws, 10, 30), _ev(ws, 35, 45), _ev(ws, 60, 65), _ev(ws, 70, 90),
           _ev("elementwise_kernel", 52, 58)]
    host = [_ev(trace.UNIT, 50, 50), _ev(trace.UNIT, 95, 95)]
    s = trace.summarize(dev, host, 0.0, 100.0)
    sec, n = trace.first_launches(s, "wide_shade_kernel")
    assert n == 2 and abs(sec - 25e-6) < 1e-12
    assert trace.first_launches(s, "wide_exact_kernel") == (0, 0)
