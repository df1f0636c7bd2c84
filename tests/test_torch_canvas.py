"""``canvas.Canvas``: one assembly rule for the fused, fused-seg and gather
engines, and its two forms.

Where the rule concatenates, the paste form of the same plane (its lines
over the whole canvas) must give the same canvas bit for bit, from the
same interior, strips and source; a plane whose exception line lies
outside its interior rectangle must paste. The benchmark's
configurations, at the CPU stand-ins their files give (``standin``), keep
the engine and the form every plane took before the rule was shared:
concatenate on the fused and gather planes, paste on the tap-16 fused-seg
planes; the tap-8 fused-seg upscale concatenates.
"""

import json
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from jincresize_tpu_torch.api import JincConfig, JincResizer
from jincresize_tpu_torch.apply_conv import ConvApplier
from jincresize_tpu_torch.apply_conv_seg import SegConvApplier
from jincresize_tpu_torch.clip import VideoFormat
from jincresize_tpu_torch.kernels import lines as lines_k
from jincresize_tpu_torch.operator import build_plane_operator, radius_for_tap
from jincresize_tpu_torch.phase import plan_phases, plan_phases_seg

CONFIGS = Path(__file__).resolve().parents[1] / "benchmark" / "configs"
# Each configuration's form on every plane: one concatenate (True) or the
# paste (False).
FORMS = {
    "jinc256_2160p_to_4320p_yuv420p8": True,
    "jinc36_1080p_to_2160p_yuv420p8": True,
    "jinc_tap16_1440p_to_1080p_yuv420p10": False,
    "jinc_tap16_2160p_to_768p_yuv420p8": True,
    "jinc256_1440p_to_2160p_yuv420p10": True,
}
GATHER = "jinc_tap16_2160p_to_768p_yuv420p8"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's tests: pytest-xdist runs
    several workers on one machine, and each worker's default pool (a
    thread a core) oversubscribes the cores. The old count is back after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def standin(name):
    """(configuration, its resizer at the stand-in size on the CPU), with
    the engines ``impl='auto'`` takes on a card."""
    config = json.loads((CONFIGS / f"{name}.json").read_text())
    s = config["standin"]
    jc = dict(config["jinc_config"], target_width=s["target_width"],
              target_height=s["target_height"], impl="pallas", operator_cache=False)  # fmt: skip
    r = JincResizer(VideoFormat(**config["format"]), s["src_width"], s["src_height"],
                    JincConfig(**jc), device="cpu")  # fmt: skip
    return config, r


@pytest.fixture(scope="module")
def gather_standin():
    """The gather configuration's stand-in: its fs-92 and fs-93 operators
    take most of this module's time to build, so they are built once."""
    return standin(GATHER)


def forms_agree(ap, exc_x=(), exc_y=(), seed=0):
    """Both forms of ``ap``'s canvas from one random source, interior and
    set of strips: the form the rule chose, which must concatenate, and the
    paste, its lines over the whole canvas."""
    canvas = ap.canvas
    assert canvas.concat
    paste = replace(canvas, concat=False, lines=lines_k.make_lines(ap._dop, exc_x, exc_y))
    g = torch.Generator().manual_seed(seed)
    dop = ap._dop
    src_f = torch.rand((2, dop.src_height, dop.src_width), generator=g)
    ylo, yhi, xlo, xhi = canvas.rect
    interior = torch.rand((2, yhi - ylo, xhi - xlo), generator=g)
    strips = {(s.y0, s.y1, s.x0, s.x1): torch.rand((2, s.y1 - s.y0, s.x1 - s.x0), generator=g)
              for s in dop.strips}  # fmt: skip
    want = paste.assemble(interior.clone(), strips, src_f)
    got = canvas.assemble(interior.clone(), strips, src_f)
    assert got.shape == (2, dop.dst_height, dop.dst_width)
    assert torch.equal(got, want)


def case_fused_exceptions(gather_standin):
    """The fused 5/2 plane: exception columns and rows inside the framed
    rectangle, written over the middle block."""
    op = build_plane_operator(160, 120, 400, 300, radius_for_tap(3))
    plan = plan_phases(op)
    ap = ConvApplier(op, plan=plan, device="cpu")
    assert len(plan.x.exceptions) and len(plan.y.exceptions)
    assert ap.canvas.lines is not None and ap.canvas.lines.origin == (ap.canvas.rect[0], 0)
    forms_agree(ap, plan.x.exceptions, plan.y.exceptions)


def case_gather_standin(gather_standin):
    _, r = gather_standin
    for ap in (r._applier_luma, r._applier_chroma):
        assert ap.canvas.lines is None
        forms_agree(ap, seed=1)


def case_seg_framed(gather_standin):
    """The drifted 1.5x tap-8 seg plane, framed by its strips."""
    op = build_plane_operator(640, 360, 960, 540, radius_for_tap(8))
    plan = plan_phases_seg(op)
    ap = SegConvApplier(op, plan=plan, device="cpu")
    forms_agree(ap, plan.x.exceptions, plan.y.exceptions, seed=2)


def case_line_outside_pastes(gather_standin):
    """The tap-16 stand-in's luma plane, 256x144 -> 192x108: its exception
    lines lie just outside the seg plan's rectangle, so it pastes, its
    lines over the whole canvas."""
    op = build_plane_operator(256, 144, 192, 108, radius_for_tap(16))
    plan = plan_phases_seg(op)
    ap = SegConvApplier(op, plan=plan, device="cpu")
    ylo, yhi, xlo, xhi = ap.canvas.rect
    outside = [x for x in plan.x.exceptions if not xlo <= x < xhi]
    outside += [y for y in plan.y.exceptions if not ylo <= y < yhi]
    assert outside and not ap.canvas.concat
    assert ap.canvas.lines is not None and ap.canvas.lines.origin == (0, 0)


def standin_keeps_its_form(name):
    def case(gather_standin):
        config, r = gather_standin if name == GATHER else standin(name)
        assert r.engines == config["engines"]
        for ap in (r._applier_luma, r._applier_chroma):
            assert ap.canvas.concat == FORMS[name], (name, ap.canvas.rect)

    return case


CASES = {
    "fused-exceptions-concat": case_fused_exceptions,
    "gather-standin-concat": case_gather_standin,
    "seg-1.5x-tap8-concat": case_seg_framed,
    "tap16-line-outside-pastes": case_line_outside_pastes,
    **{f"standin-{name}": standin_keeps_its_form(name) for name in FORMS},
}


@pytest.mark.parametrize("name", list(CASES))
def test_canvas_forms(name, gather_standin):
    CASES[name](gather_standin)
