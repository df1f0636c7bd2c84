"""Public API: JincResize with the reference's 16-parameter surface, on torch.

Port of ``jincresize_tpu/api.py``: the same ``JincConfig`` fields and
defaults, the same validation messages, the same ``_ChromaLocation``
handling and the four ``jinc*_resize`` aliases. Operators are built by the
port's NumPy host layer (``operator``, ``phase``; copies of the JAX
package's) and carried to an explicit torch ``device``.

Engines (``JincResizer.engines`` records the one each plane ran, under the
JAX package's names):

* ``'fused'`` -- ``apply_conv.ConvApplier``: the hand-written interior and
  strip kernels on CUDA tensors (their plain forms on CPU tensors);
* ``'fused-seg'`` -- ``apply_conv_seg.SegConvApplier``: the segment-periodic
  kernel for drifted rational scales;
* ``'gather'`` -- ``apply_gather.GatherApplier``: the gather kernel for any
  geometry;
* ``'xla'`` -- ``apply_xla``: the general gather-MAC in plain torch;
* ``'numpy'`` -- the shared host golden (``golden.apply_plane_numpy``);
* ``'sharded/<interior>'`` -- ``sharding.ShardedApplier``: destination rows
  split over the row shards of a ``sharding.RowMesh`` of torch devices
  (frames over its data rows), each shard running the ``conv-fused``,
  ``seg``, ``gather`` (band kernel) or ``gather-scan`` interior on its band
  of source rows.

``impl='auto'`` picks ``fused`` whenever the plan is periodic, deep taps
(fs**2 > 1200, tap-16 downscales) and every output size included: the
kernel's only envelope is the shared memory of its weights, which every plan
of ``phase.plan_phases`` fits. On a CUDA device it then tries ``fused-seg`` and
``gather`` (the counterpart of the JAX package's TPU-only step); else
``xla``. The seg kernel takes drifted plans at any filter size whose tile
pair blocks fit its shared memory (2560x1440 -> 1920x1080 tap 16, fs 44),
and the gather kernel any plan with a dictionary and an interior
(3840x2160 -> 1366x768 tap 16, fs 92), so deep-tap plans take ``fused-seg``
or ``gather`` on the card where the JAX package, whose seg and gather
envelopes end at fs**2 = 1200, takes ``xla``; only plans with no dictionary
or no interior (border-only operators) reach ``xla`` there. Off the card
``auto`` stays ``fused`` -> ``xla``. ``'conv'`` runs ``fused`` or raises;
``'seg'`` and ``'gather'`` run their engine or raise; ``'pallas'`` runs the
first hand-written engine of ``fused`` -> ``fused-seg`` -> ``gather`` or
raises. ``'sharded'``, or
``'auto'`` with a ``mesh``, runs the sharded engine on every plane; with no
mesh it takes ``sharding.make_mesh`` over every visible device of the
resizer's device type. A mesh with any other ``impl`` raises ``JincError``,
and so does a mesh that spans processes (``distributed.global_mesh``): a
resizer returns whole frames, and there each process holds only its rows
(``sharding.ShardedApplier`` returns them).

``ChainResizer`` / ``jinc_resize_chain`` compose a chain of resizes into one
operator per plane (``compose.compose``), which re-enters the same engine
selection.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace

import numpy as np
import torch

from .clip import Clip, Frame, VideoFormat
from .filters import build_lut
from .geometry import build_plane_geometry, chroma_crop
from .golden import apply_plane_numpy
from .metrics import logger
from .operator import PlaneOperator, build_plane_operator, radius_for_tap
from .phase import geometry_is_periodic, plan_phases, plan_phases_seg

from . import apply_xla
from .apply_conv import ConvApplier
from .apply_conv_seg import SegConvApplier
from .apply_gather import GatherApplier
from .kernels import fused as fused_k
from .kernels import gather as gather_k
from .kernels import seg as seg_k
from .sharding import ShardedApplier, make_mesh


class JincError(ValueError):
    """Construction-time validation error (reference: avs_new_value_error)."""


@dataclass(frozen=True)
class JincConfig:
    """All JincResize parameters with reference defaults.

    A copy of ``jincresize_tpu.api.JincConfig`` (whose module imports jax);
    see there for each field's meaning.
    """

    target_width: int
    target_height: int
    src_left: float = 0.0
    src_top: float = 0.0
    src_width: float | None = None  # <=0: crop from the right
    src_height: float | None = None  # <=0: crop from the bottom
    quant_x: int = 256
    quant_y: int = 256
    tap: int = 3
    blur: float = 0.0  # 0 means unset -> 1.0
    cplace: str | None = None  # None: resolve from frame props, else mpeg2
    threads: int = 0
    opt: int = -1
    initial_capacity: int | None = None
    initial_factor: float = 1.5
    impl: str = "auto"  # 'auto'|'conv'|'seg'|'gather'|'xla'|'pallas'|'numpy'|'sharded'
    float_clamp: bool | None = None  # None: clamp float sources unless opt == 0
    precision: str = "fp32"  # 'fp32' | 'bf16'
    pos_precision: str = "f32"  # 'f32' (reference walk) | 'f64' (drift-free)
    operator_cache: bool = True


def _resolve_cplace(cfg: JincConfig, fmt: VideoFormat, frame0: Frame | None) -> str:
    cplace = cfg.cplace
    if cplace:
        cplace = cplace.lower()
        if cplace not in ("mpeg2", "mpeg1", "topleft"):
            raise JincError("JincResize: cplace must be MPEG2, MPEG1 or topleft.")
    else:
        # Frame-prop fallback.
        loc = None if frame0 is None else frame0.props.get("_ChromaLocation")
        if loc is None:
            cplace = "mpeg2"
        elif loc == 0:
            cplace = "mpeg2"
        elif loc == 1:
            cplace = "mpeg1"
        elif loc == 2:
            cplace = "topleft"
        else:
            raise JincError("JincResize: invalid _ChromaLocation")
    if cplace == "topleft" and not fmt.is_420:
        raise JincError(
            "JincResize: topleft must be used only for 4:2:0 chroma subsampling."
        )
    return cplace


def _validate(cfg: JincConfig) -> None:
    """Reference argument validation with identical messages."""
    if not 1 <= cfg.tap <= 16:
        raise JincError("JincResize: tap must be between 1..16.")
    if not 1 <= cfg.quant_x <= 256:
        raise JincError("JincResize: quant_x must be between 1..256.")
    if not 1 <= cfg.quant_y <= 256:
        raise JincError("JincResize: quant_y must be between 1..256.")
    if cfg.opt > 3:
        raise JincError("JincResize: opt higher than 3 is not allowed.")
    if cfg.threads not in (0, 1):
        raise JincError("JincResize: threads must be either 0 or 1.")
    if cfg.initial_factor < 1.0:
        raise JincError(
            "JincResize: initial_factor must be eqaul to or greater than 1.0."
        )
    if cfg.initial_capacity is not None and cfg.initial_capacity <= 0:
        raise JincError("JincResize: initial_capacity must be greater than 0.")
    if cfg.impl not in (
        "auto",
        "conv",
        "seg",
        "gather",
        "xla",
        "pallas",
        "numpy",
        "sharded",
    ):
        raise JincError(f"JincResize: unknown impl {cfg.impl!r}.")
    if cfg.precision not in ("fp32", "bf16"):
        raise JincError(f"JincResize: unknown precision {cfg.precision!r}.")
    if cfg.pos_precision not in ("f32", "f64"):
        raise JincError(
            f"JincResize: unknown pos_precision {cfg.pos_precision!r}."
        )


def _select_engine(op: PlaneOperator, impl: str, precision: str, device):
    """Pick the execution engine for one plane operator.

    Returns (applier_or_None, engine_name): ``'fused'``, ``'fused-seg'`` or
    ``'gather'`` with its applier, or ``'xla'`` with none. Every accepted
    ``impl`` runs what it names or raises. There is no size gate on
    ``fused-seg`` or on deep-tap ``fused``: the JAX package's
    ``JINCRESIZE_SEG_MIN_PIXELS`` and ``JINCRESIZE_DEEP_FUSED_MIN_PIXELS``
    exist for a Mosaic compile of minutes, which the CUDA kernels do not have.
    """
    def try_seg():
        plan = plan_phases_seg(op)
        if plan is None or not seg_k.is_supported(op, plan):
            return None
        return SegConvApplier(op, plan=plan, precision=precision, device=device)

    def try_gather():
        return GatherApplier(op, device=device) if gather_k.is_supported(op) else None

    if impl == "seg":
        app = try_seg()
        if app is None:
            raise JincError(
                "JincResize: impl='seg' — geometry has no usable "
                "segment-periodic structure (use impl='auto' for automatic "
                "fallback)."
            )
        return app, "fused-seg"
    if impl == "gather":
        app = try_gather()
        if app is None:
            raise JincError(
                "JincResize: impl='gather' — geometry outside the gather "
                "kernel envelope (use impl='auto' for automatic fallback)."
            )
        return app, "gather"
    plan = plan_phases(op)
    if plan is not None and fused_k.is_supported(op, plan):
        return ConvApplier(op, plan=plan, precision=precision, device=device), "fused"
    if impl == "conv":
        raise JincError(
            "JincResize: impl='conv' requires periodic geometry "
            "(use impl='auto' for automatic fallback)."
        )
    if impl == "pallas" or device.type == "cuda":
        app = try_seg()
        if app is not None:
            return app, "fused-seg"
        app = try_gather()
        if app is not None:
            return app, "gather"
    if impl == "pallas":
        raise JincError(
            "JincResize: impl='pallas' — geometry is outside all Pallas "
            "kernel envelopes (use impl='auto' for automatic fallback)."
        )
    return None, "xla"


def _check_mesh(mesh) -> None:
    """A resizer returns whole frames, so its mesh must be this process's:
    a mesh that spans processes (``distributed.global_mesh``) holds rows
    that no one process can return."""
    if mesh is not None and mesh.spans_ranks:
        raise JincError(
            "JincResize: the mesh spans several processes, whose rows no one "
            "process holds; run each plane through sharding.ShardedApplier, "
            "which returns this process's rows (.index, .data)."
        )


class JincResizer:
    """Constructed filter instance: operators built once, frames are calls.

    ``device`` is where the device engines run; ``'cuda'`` without a visible
    GPU raises instead of running on the CPU. ``mesh`` (a
    ``sharding.RowMesh``) routes every plane through the sharded engine.
    """

    def __init__(
        self,
        fmt: VideoFormat,
        width: int,
        height: int,
        cfg: JincConfig,
        frame0: Frame | None = None,
        device="cuda",
        mesh=None,
    ):
        _validate(cfg)
        _check_mesh(mesh)
        if mesh is not None and cfg.impl not in ("auto", "sharded"):
            raise JincError(
                "JincResize: mesh is only valid with impl='sharded' or 'auto'."
            )
        self.device = apply_xla.resolve_device(device)
        self.fmt = fmt
        self.src_width = width
        self.src_height = height
        self.cfg = cfg
        self.cplace = _resolve_cplace(cfg, fmt, frame0)

        # Crop semantics including negative src_width/height = right/bottom crop.
        crop_left = cfg.src_left
        crop_width = float(width) if cfg.src_width is None else float(cfg.src_width)
        if crop_width <= 0.0:
            crop_width = width - crop_left + crop_width
        crop_top = cfg.src_top
        crop_height = float(height) if cfg.src_height is None else float(cfg.src_height)
        if crop_height <= 0.0:
            crop_height = height - crop_top + crop_height

        blur = cfg.blur if cfg.blur else 1.0
        tw, th = cfg.target_width, cfg.target_height
        radius = radius_for_tap(cfg.tap)
        lut = build_lut(radius, blur)
        self.peak = fmt.peak
        pos_precision = None if cfg.pos_precision == "f32" else cfg.pos_precision

        def _build(**geometry):
            if cfg.operator_cache:
                from .cache import cached_build

                return cached_build(
                    lambda **g: build_plane_operator(lut=lut, **g), **geometry
                )
            return build_plane_operator(lut=lut, **geometry)

        # Luma/444/RGB operator (also used for alpha planes).
        self.op_luma: PlaneOperator = _build(
            src_width=width,
            src_height=height,
            dst_width=tw,
            dst_height=th,
            radius=radius,
            crop_left=crop_left,
            crop_top=crop_top,
            crop_width=crop_width,
            crop_height=crop_height,
            quantize_x=cfg.quant_x,
            quantize_y=cfg.quant_y,
            blur=blur,
            pos_precision=pos_precision,
        )
        # Subsampled chroma operator with the chroma-siting shift.
        self.op_chroma: PlaneOperator | None = None
        if fmt.family == "YUV" and fmt.is_subsampled:
            cl, ct, cw, ch = chroma_crop(
                self.cplace,
                width,
                height,
                tw,
                th,
                crop_left,
                crop_top,
                crop_width,
                crop_height,
                fmt.sub_w,
                fmt.sub_h,
            )
            self.op_chroma = _build(
                src_width=width >> fmt.sub_w,
                src_height=height >> fmt.sub_h,
                dst_width=tw >> fmt.sub_w,
                dst_height=th >> fmt.sub_h,
                radius=radius,
                crop_left=cl,
                crop_top=ct,
                crop_width=cw,
                crop_height=ch,
                quantize_x=cfg.quant_x,
                quantize_y=cfg.quant_y,
                blur=blur,
                pos_precision=pos_precision,
            )
        # Luma geometry kwargs, kept for the drift hint.
        self._luma_geometry = dict(
            src_width=width,
            src_height=height,
            dst_width=tw,
            dst_height=th,
            radius=radius,
            crop_left=crop_left,
            crop_top=crop_top,
            crop_width=crop_width,
            crop_height=crop_height,
            quantize_x=cfg.quant_x,
            quantize_y=cfg.quant_y,
        )
        self._init_engines(mesh)

        # Float-source clamp per plane (SIMD semantics unless opt==0).
        clamp = cfg.float_clamp
        if clamp is None:
            clamp = cfg.opt != 0
        self._float_clamp = clamp and fmt.bits == 32

    # --------------------------------------------------------------- engines
    def _init_engines(self, mesh=None) -> None:
        """Select and build the engine per plane operator into ``engines``."""
        cfg, fmt = self.cfg, self.fmt
        self._impl = cfg.impl
        self._dev_luma = None
        self._dev_chroma = None
        self._applier_luma = None
        self._applier_chroma = None
        self.engines: dict[str, str] = {}
        # u8 planes are bf16-exact; the JAX package runs a weight-split kernel
        # for them, the port the same exact fp32 kernel. 'bf16' stays 'bf16'
        # at every bit depth, and no engine choice depends on the precision.
        prec = cfg.precision
        if prec == "fp32" and fmt.bits == 8:
            prec = "fp32_u8src"
        if self._impl == "numpy":
            self.engines["luma"] = "numpy"
            if self.op_chroma is not None:
                self.engines["chroma"] = "numpy"
            return
        ops = {"luma": self.op_luma, "chroma": self.op_chroma}
        if self._impl == "sharded" or (self._impl == "auto" and mesh is not None):
            if mesh is None:
                mesh = make_mesh(device_type=self.device.type)
            for plane, op in ops.items():
                if op is not None:
                    app = ShardedApplier(op, mesh, precision=prec)
                    setattr(self, f"_applier_{plane}", app)
                    self.engines[plane] = f"sharded/{app.interior}"
            self._impl = "sharded"
            return
        for plane, op in ops.items():
            if op is None:
                continue
            app, eng = (None, "xla")
            if self._impl != "xla":
                app, eng = _select_engine(op, self._impl, prec, self.device)
            dev = apply_xla.to_device(op, self.device) if app is None else None
            setattr(self, f"_applier_{plane}", app)
            setattr(self, f"_dev_{plane}", dev)
            self.engines[plane] = eng
        self._maybe_drift_hint()

    def _maybe_drift_hint(self) -> None:
        """Log when float32 position drift kept a rational geometry off the
        fused kernel: with float64 positions it would plan periodic."""
        cfg = self.cfg
        geo = getattr(self, "_luma_geometry", None)
        if (
            geo is None
            or cfg.impl != "auto"
            or cfg.pos_precision != "f32"
            or self.engines.get("luma") not in ("gather", "xla")
        ):
            return
        # dists=False: the probe needs only classes, starts and borders.
        if geometry_is_periodic(build_plane_geometry(pos_dtype="f64", dists=False, **geo)):
            logger.info(
                "geometry is quasi-periodic: float32 position drift forced the %s "
                "path; impl='seg' (the segment-periodic kernel, at bit parity) or "
                "pos_precision='f64' (documented non-parity mode, exactly periodic) "
                "would run this request on a faster kernel.",
                self.engines["luma"],
            )

    # ------------------------------------------------------------------ plane
    def _plane_op(self, name: str):
        """Chroma planes use the chroma operator for subsampled formats,
        everything else (incl. alpha) the luma operator."""
        if name in ("U", "V") and self.op_chroma is not None:
            return self.op_chroma, self._dev_chroma, self._applier_chroma
        return self.op_luma, self._dev_luma, self._applier_luma

    def _clamp_min(self, name: str) -> float | None:
        if not self._float_clamp:
            return None
        # (i && !is_rgb) -> -0.5 else 0.0
        if self.fmt.family != "RGB" and name != self.fmt.plane_names[0]:
            return -0.5
        return 0.0

    def _resize_planes(self, name: str, src: np.ndarray) -> np.ndarray:
        """Resample a batch (F, h, w) of one plane through the selected engine."""
        op, dop, app = self._plane_op(name)
        cmin = self._clamp_min(name)
        dtype, peak = self.fmt.dtype, self.peak
        # SIMD store semantics under the reference's default dispatch
        # (opt != 0): 9..15-bit stores saturate at the u16 type max, not at
        # peak; only opt=0 selects the C kernel's peak clamp.
        if self.cfg.opt != 0 and 8 < self.fmt.bits < 16:
            peak = 65535.0
        if self._impl == "numpy":
            return np.stack(
                [
                    apply_plane_numpy(
                        op, s, out_dtype=dtype, peak=peak, float_clamp_min=cmin
                    )
                    for s in src
                ]
            )
        t = torch.from_numpy(np.ascontiguousarray(src)).to(self.device)
        if app is not None:
            out = app(t, out_dtype=dtype, peak=peak, float_clamp_min=cmin)
        else:
            out = apply_xla.resize_plane_batch(
                dop, t, out_dtype=dtype, peak=peak, float_clamp_min=cmin
            )
        return out.cpu().numpy()

    def _out_frame(self, planes: dict, props: dict) -> Frame:
        out = Frame(format=self.fmt, planes=planes, props=dict(props))
        # _ChromaLocation output prop for 420/422/411.
        if self.fmt.is_420 or self.fmt.is_422 or self.fmt.is_411:
            loc = {"mpeg2": 0, "mpeg1": 1, "topleft": 2}[self.cplace]
            out = out.with_props(_ChromaLocation=loc)
        return out

    def process_frame(self, frame: Frame) -> Frame:
        """Resample one frame (all planes). No state is mutated."""
        frame.validate()
        out_planes = {
            name: self._resize_planes(name, np.asarray(frame.planes[name])[None])[0]
            for name in self.fmt.plane_names
        }
        return self._out_frame(out_planes, frame.props)

    def process_clip_batched(self, clip: Clip) -> Clip:
        """Resample all frames in one batched call per plane."""
        for f in clip.frames:
            f.validate()
        out_by_plane = {
            name: self._resize_planes(
                name, np.stack([f.planes[name] for f in clip.frames], axis=0)
            )
            for name in self.fmt.plane_names
        }
        frames = tuple(
            self._out_frame(
                {n: out_by_plane[n][i] for n in self.fmt.plane_names}, f.props
            )
            for i, f in enumerate(clip.frames)
        )
        return Clip(
            format=self.fmt,
            frames=frames,
            width=self.cfg.target_width,
            height=self.cfg.target_height,
        )

    def __call__(self, clip: Clip) -> Clip:
        if len(clip.frames) > 1 and self._impl != "numpy":
            return self.process_clip_batched(clip)
        frames = tuple(self.process_frame(f) for f in clip.frames)
        return Clip(
            format=self.fmt,
            frames=frames,
            width=self.cfg.target_width,
            height=self.cfg.target_height,
        )


def jinc_resize(
    clip: Clip,
    target_width: int,
    target_height: int,
    device="cuda",
    mesh=None,
    **kwargs,
) -> Clip:
    """``JincResize(clip, target_width, target_height, ...)`` on ``device``,
    or on the row shards of ``mesh`` (a ``sharding.RowMesh``)."""
    cfg = JincConfig(target_width=target_width, target_height=target_height, **kwargs)
    frame0 = clip.frames[0] if len(clip.frames) else None
    resizer = JincResizer(
        clip.format, clip.width, clip.height, cfg, frame0=frame0, device=device, mesh=mesh
    )
    return resizer(clip)


class ChainResizer(JincResizer):
    """Composed multi-stage resizer: one operator for a whole chain.

    The per-stage operators are composed on the host (``compose.compose``)
    into one banded operator per plane, so a frame takes one pass with no
    intermediate rounding, and the composed operator goes through the same
    engine selection as a single stage (fused, seg, gather or sharded).
    Composed operators are cached under ``cache.default_cache_dir()``, keyed
    by the whole chain and the plane.
    """

    def __init__(
        self,
        fmt: VideoFormat,
        width: int,
        height: int,
        cfgs: list[JincConfig],
        frame0: Frame | None = None,
        device="cuda",
        mesh=None,
    ):
        if not cfgs:
            raise JincError("JincResize: chain needs at least one stage.")
        _check_mesh(mesh)
        from . import compose as compose_mod
        from .cache import default_cache_dir, geometry_key, load_operator, save_operator

        # cplace resolves once, from the first stage (later stages would read
        # the _ChromaLocation prop the previous stage wrote: the same value).
        cpl = _resolve_cplace(cfgs[0], fmt, frame0)
        for cfg in cfgs:
            _validate(cfg)
        last = cfgs[-1]
        self.device = apply_xla.resolve_device(device)

        # Composed-operator cache: keyed by the full stage chain and the plane.
        cache_paths = {}
        if all(c.operator_cache for c in cfgs):

            def _desc(c: JincConfig) -> dict:
                d = asdict(c)
                # Drop everything that does not affect coefficients.
                for k in (
                    "impl",
                    "precision",
                    "operator_cache",
                    "threads",
                    "opt",
                    "initial_capacity",
                    "initial_factor",
                    "float_clamp",
                    "cplace",
                ):
                    d.pop(k, None)
                if d.get("pos_precision") == "f32":
                    d.pop("pos_precision")
                return d

            base = dict(
                chain=[_desc(c) for c in cfgs],
                cplace=cpl,
                src=[width, height],
                sub=[fmt.sub_w, fmt.sub_h],
                family=fmt.family,
            )
            for plane in ("luma", "chroma"):
                key = geometry_key(plane=plane, **base)
                cache_paths[plane] = default_cache_dir() / f"chain_{key}.npz"

        def _load(plane):
            p = cache_paths.get(plane)
            if p is not None and p.exists():
                try:
                    return load_operator(p)
                except Exception:
                    pass  # corrupt cache entry: compose again
            return None

        def _compose(plane, attr):
            op = getattr(self.stages[0], attr)
            for r in self.stages[1:]:
                op = compose_mod.compose(op, getattr(r, attr))
            if cache_paths:
                try:
                    save_operator(op, cache_paths[plane])
                except OSError:
                    pass  # cache write failure is non-fatal
            return op

        need_chroma = fmt.family == "YUV" and fmt.is_subsampled
        composed_luma = _load("luma")
        composed_chroma = _load("chroma") if need_chroma else None
        self.stages = []
        if composed_luma is None or (need_chroma and composed_chroma is None):
            # Stage resizers are built engine-less (impl='numpy'): only their
            # operators are used. cplace is pinned to the resolved value so
            # the chroma siting matches chained execution.
            w, h = width, height
            for cfg in cfgs:
                r = JincResizer(
                    fmt, w, h, replace(cfg, impl="numpy", cplace=cpl), device=self.device
                )
                self.stages.append(r)
                w, h = cfg.target_width, cfg.target_height
            if composed_luma is None:
                composed_luma = _compose("luma", "op_luma")
            if need_chroma and composed_chroma is None:
                composed_chroma = _compose("chroma", "op_chroma")

        # Adopt the final stage's identity, then install the composed
        # operators and select engines exactly like a single-stage resizer.
        self.fmt = fmt
        self.src_width = width
        self.src_height = height
        self.cfg = last
        self.cplace = cpl
        self.peak = fmt.peak
        self.op_luma = composed_luma
        self.op_chroma = composed_chroma
        self._init_engines(mesh)
        clamp = last.float_clamp
        if clamp is None:
            clamp = last.opt != 0
        self._float_clamp = clamp and fmt.bits == 32


def jinc_resize_chain(clip: Clip, stages: list[dict], device="cuda", mesh=None) -> Clip:
    """Run a chain of resizes as ONE composed operator pass.

    ``stages`` is a list of ``jinc_resize`` keyword dicts (each needs
    ``target_width``/``target_height``). Equal to nested ``jinc_resize`` calls
    for float clips, minus the intermediate passes; for integer clips it
    skips the intermediate round/clamp (a documented deviation from running
    the stages separately).
    """
    cfgs = [JincConfig(**s) for s in stages]
    frame0 = clip.frames[0] if len(clip.frames) else None
    r = ChainResizer(
        clip.format, clip.width, clip.height, cfgs, frame0=frame0, device=device, mesh=mesh
    )
    return r(clip)


def _alias(tap: int):
    """Fixed-tap alias: forwards the reduced parameter set and pins tap."""

    def fn(
        clip: Clip,
        target_width: int,
        target_height: int,
        src_left: float = 0.0,
        src_top: float = 0.0,
        src_width: float | None = None,
        src_height: float | None = None,
        quant_x: int = 256,
        quant_y: int = 256,
        cplace: str | None = None,
        threads: int = 0,
        **extra,
    ) -> Clip:
        return jinc_resize(
            clip,
            target_width,
            target_height,
            src_left=src_left,
            src_top=src_top,
            src_width=src_width,
            src_height=src_height,
            quant_x=quant_x,
            quant_y=quant_y,
            cplace=cplace,
            threads=threads,
            tap=tap,
            **extra,
        )

    fn.__name__ = f"jinc{tap * tap * 4}_resize"
    return fn


jinc36_resize = _alias(3)
jinc64_resize = _alias(4)
jinc144_resize = _alias(6)
jinc256_resize = _alias(8)
