"""The control, on the card: the program with its transforms at HIGH (TF32
on the H100) fails the check that the program at its stated precision
passes, at a size a test run holds (the render cell cut to 8 channels)."""

from benchmark import control


def test_control_fails_and_program_passes(gpu):
    w = "render64_ir10s_f32.device_io"
    kw = {"overrides": {"channels": 8}}
    ctl = control.readings(w, [11, 12], 1.0, True, **kw)
    prog = control.readings(w, [11, 12], 1.0, False, **kw)
    assert all(not r["correct"] for r in ctl), ctl
    assert all(r["correct"] for r in prog), prog
    assert min(r["rel_rms_err"]["value"] for r in ctl) > 3 * max(
        r["rel_rms_err"]["value"] for r in prog)
