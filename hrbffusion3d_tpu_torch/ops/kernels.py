"""Hand-written kernels of the port: build, binding, launch counts, and the
ray cast with its plain PyTorch version.

Four kernels, each the counterpart of a TPU kernel of
``hrbffusion3d_tpu/ops/pallas_kernels.py``, in CUDA C++ for sm_90a:

  ==================  ========================  ==========================
  kernel              source (``csrc/``)        wrapper and plain version
  ==================  ========================  ==========================
  raycast_core        raycast.cu                here: ``raycast_core`` /
                                                ``raycast_core_ref``
  bilateral_filter    preprocess.cu             ``ops/preprocess.py``
  normal_pca          preprocess.cu             ``ops/preprocess.py``
  curvature_gradient  preprocess.cu             ``ops/preprocess.py``
  ==================  ========================  ==========================

The tensor's device picks the path in every wrapper: a CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises.  There is no
fallback from the kernel to the plain version.

At the first CUDA call ``build`` compiles every source with ``nvcc`` (one
process per source, all started together) into plain-C shared libraries
under ``hrbffusion3d_tpu_torch/_build/``, named by the hash of the source so
a changed source is rebuilt, and loads them with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from ..config import CameraIntrinsics, SLAMConfig
from ..utils.tensors import const

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel -> (source in csrc/, C entry point, its argument types before the
# trailing stream)
_ENTRIES = {
    "raycast_core": ("raycast.cu", "raycast_core_launch",
                     [_P] * 5 + [_I] * 8 + [_F, _P, _I, _P] + [_I] * 5 + [_F] * 4),
    "bilateral_filter": ("preprocess.cu", "bilateral_filter_launch",
                         [_P, _P, _I, _I, _F, _F, _I]),
    "normal_pca": ("preprocess.cu", "normal_pca_launch", [_P, _P, _I, _I, _F]),
    "curvature_gradient": ("preprocess.cu", "curvature_gradient_launch",
                           [_P] * 6 + [_I] * 3 + [_F] * 3),
}
# kernel -> (source, C entry point reporting what the kernel compiled to,
# its integer arguments before the output pointer)
_ATTRIBUTES = {
    "raycast_core": ("raycast.cu", "raycast_core_attributes", 2),
    "bilateral_filter": ("preprocess.cu", "bilateral_filter_attributes", 0),
    "normal_pca": ("preprocess.cu", "normal_pca_attributes", 0),
    "curvature_gradient": ("preprocess.cu", "curvature_gradient_attributes", 1),
}
# ladder taps (and k-section points) the ray-cast kernel evaluates per pass
# over its taps (kLadderBatch in csrc/raycast.cu)
RAYCAST_LADDER_BATCH = 4

# launches of each kernel (one per wrapper call on a CUDA tensor, counted
# nowhere else); callers reset and read them to show a run went through
# the kernels
LAUNCHES = dict.fromkeys(_ENTRIES, 0)
BUILD_SECONDS: dict[str, float] = {}   # source -> nvcc wall time in this process
PTXAS: dict[str, list[str]] = {}       # source -> ptxas register / spill lines

_FNS: dict[str, ctypes._CFuncPtr] = {}
_ATTR_FNS: dict[str, ctypes._CFuncPtr] = {}


def ring_taps(radius: int) -> list[tuple[int, int]]:
    """Window offsets in ring (Chebyshev) order, (dy, dx) lexicographic
    within a ring: the neighbour collection order of predict_hrbf.frag."""
    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    offs.sort(key=lambda o: (max(abs(o[0]), abs(o[1])), o[0], o[1]))
    return offs


@functools.lru_cache(maxsize=None)
def ring_table(radius: int):
    """``ring_taps(radius)`` as the kernel takes it: a C array of int8
    (dy, dx) pairs."""
    flat = [o for tap in ring_taps(radius) for o in tap]
    return (ctypes.c_int8 * len(flat))(*flat)


def _variant(cfg: SLAMConfig):
    """(ladder offsets in metres as Python floats, false-position
    iterations, bisection iterations, k-section points per pass, k-section
    passes) of the kernel's refinement: false position when its count is
    > 0, else k-section when ``raycast_bisection_batch`` > 1, else
    bisection."""
    from .raycast import bisection_plan, ladder_offsets

    offs, bis = ladder_offsets(cfg)
    fp = cfg.raycast_false_position if cfg.raycast_geometric_ladder else 0
    ksec_b, ksec_p = bisection_plan(cfg)
    return [float(o * cfg.raycast_coarse_step) for o in offs], fp, bis, ksec_b, ksec_p


@functools.lru_cache(maxsize=8)
def _launch_variant(cfg: SLAMConfig):
    """``_variant(cfg)`` with the ladder as the C array the kernel takes
    and its length (made once per configuration)."""
    ladder, fp, bis, ksec_b, ksec_p = _variant(cfg)
    if len(ladder) > 64:
        raise ValueError("raycast_core: the kernel takes at most 64 ladder taps")
    return (ctypes.c_float * max(len(ladder), 1))(*ladder), len(ladder), fp, bis, ksec_b, ksec_p


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _ptxas_lines(log: str) -> list[str]:
    """``kernel: registers ... | spills ...`` per entry function of an
    ``nvcc -Xptxas -v`` log."""
    out, name, info = [], None, []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            if name:
                out.append(f"{name}: " + " | ".join(info))
            mangled = ln.split("'")[1]
            short = re.search(r"([a-z]+_kernel)", mangled)
            targ = re.search(r"ILi(\d+)E", mangled)
            name = short.group(1) if short else mangled
            name, info = f"{name}<{targ.group(1)}>" if targ else name, []
        elif name and ("registers" in ln or "spill" in ln):
            info.append(ln.split(":", 1)[-1].strip())
    if name:
        out.append(f"{name}: " + " | ".join(info))
    return out


def build() -> dict[str, ctypes._CFuncPtr]:
    """Build (where needed) and load every kernel source; returns the bound
    C entry points by kernel name.  The nvcc processes run in parallel, and
    none outlives this call."""
    if _FNS:
        return _FNS
    sources = sorted({src for src, _, _ in _ENTRIES.values()})
    lib_paths, procs = {}, {}
    try:
        for src in sources:
            path = _CSRC / src
            digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
            lib_paths[src] = _BUILD / f"lib{path.stem}_{digest}.so"
            if lib_paths[src].exists():
                continue
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = _BUILD / f".lib{path.stem}_{digest}.{os.getpid()}.so"
            log = open(_BUILD / f"{path.stem}_{digest}.{os.getpid()}.log", "w+")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-o", str(tmp), str(path)]
            procs[src] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                          tmp, log, time.perf_counter())
        while procs:
            for src in [s for s, (p, *_) in procs.items() if p.poll() is not None]:
                proc, tmp, log, t0 = procs.pop(src)
                BUILD_SECONDS[src] = time.perf_counter() - t0
                log.seek(0)
                text = log.read()
                log.close()
                os.unlink(log.name)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc {src} failed ({proc.returncode}):\n{text}")
                os.replace(tmp, lib_paths[src])
                PTXAS[src] = _ptxas_lines(text)
            time.sleep(0.05)
    finally:
        for proc, *_ in procs.values():
            proc.kill()
            proc.wait()
    libs = {src: ctypes.CDLL(str(path)) for src, path in lib_paths.items()}
    fns = {}
    for name, (src, entry, argtypes) in _ENTRIES.items():
        fn = getattr(libs[src], entry)
        fn.argtypes = argtypes + [_P]
        fn.restype = ctypes.c_int
        fns[name] = fn
    for name, (src, entry, n_int) in _ATTRIBUTES.items():
        fn = getattr(libs[src], entry)
        fn.argtypes = [_I] * n_int + [_P]
        fn.restype = ctypes.c_int
        _ATTR_FNS[name] = fn
    _FNS.update(fns)
    return _FNS


def kernel_attributes(name: str, *args: int) -> dict[str, int]:
    """What kernel ``name`` compiled to on the current card, for its
    integer arguments (ray cast: tap cap K and window radius; curvature:
    window radius; bilateral and PCA: none): registers per thread, local
    (spilled) bytes per thread and resident blocks of 256 threads per SM.
    Launches nothing."""
    build()
    out = (ctypes.c_int * 3)()
    rc = _ATTR_FNS[name](*args, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{name}: attribute query failed with error {rc}")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2])


def on_card(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    tensor (the kernel runs); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def check_input(name: str, x: torch.Tensor, shape: tuple[int, ...]) -> None:
    """Raise unless ``x`` is a contiguous float32 tensor of ``shape``."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: input must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: input shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def launch(name: str, like: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` with the C arguments ``args`` on the current
    stream of ``like``'s device; raises if the launch fails and counts it
    in ``LAUNCHES`` if it does not."""
    fn = build()[name]
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1


def _slab_rows(attr9: torch.Tensor, intr: CameraIntrinsics, top: int, height, row0: int):
    """(output rows, checked) of a ray cast over the slab ``attr9``: its
    rows ``top .. top + height - 1`` are the image rows ``row0 ..``; the
    whole image by default."""
    h_in = attr9.shape[0]
    height = h_in - top if height is None else height
    if height <= 0 or top < 0 or top + height > h_in or row0 < 0 or row0 + height > intr.height:
        raise ValueError(f"raycast_core: output rows {top}..{top + height} of a {h_in}-row "
                         f"slab at image row {row0} do not fit a {intr.height}-row image")
    return height


def raycast_core(attr9: torch.Tensor, intr: CameraIntrinsics, cfg: SLAMConfig,
                 top: int = 0, height: int | None = None, row0: int = 0):
    """Fused HRBF ray cast over an (H, W, 9) attribute image
    [pos(3) | nrm(3) | conf | radius | valid], camera frame.

    Returns (p_surf (H,W,3), grad (H,W,3) unnormalised, nearest ring-tap
    index (H,W) int32, found (H,W) bool) — the output contract of the TPU
    kernel.  On a row slab of the image (``attr9`` of any row count): the
    ``height`` rows from slab row ``top`` on, which are the image rows from
    ``row0`` on; taps outside the slab are absent, so a slab holding every
    image row within ``predict_window_multiplier`` of them gives their
    whole-image result.  CPU tensors run ``raycast_core_ref``; CUDA
    tensors launch the kernel."""
    if not on_card("raycast_core", attr9):
        return raycast_core_ref(attr9, intr, cfg, top=top, height=height, row0=row0)
    h_in, w = attr9.shape[0], intr.width
    h = _slab_rows(attr9, intr, top, height, row0)
    check_input("raycast_core", attr9, (h_in, w, 9))
    if cfg.predict_max_neighbors > 16 or cfg.predict_window_multiplier > 7:
        raise ValueError("raycast_core: the kernel takes predict_max_neighbors <= 16 "
                         "and predict_window_multiplier <= 7")
    lad, n_lad, fp, bis, ksec_b, ksec_p = _launch_variant(cfg)
    dev = attr9.device
    p_surf = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    grad = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    nearest = torch.empty((h, w), dtype=torch.int32, device=dev)
    found = torch.empty((h, w), dtype=torch.bool, device=dev)
    ring = ring_table(cfg.predict_window_multiplier)
    launch("raycast_core", attr9,
           attr9.data_ptr(), p_surf.data_ptr(), grad.data_ptr(),
           nearest.data_ptr(), found.data_ptr(), h, w, h_in, top, row0,
           cfg.predict_window_multiplier, cfg.predict_max_neighbors,
           cfg.predict_min_neighbors, cfg.predict_conf_threshold,
           ctypes.cast(lad, ctypes.c_void_p), n_lad,
           ctypes.cast(ring, ctypes.c_void_p), len(ring) // 2, fp, bis, ksec_b, ksec_p,
           intr.fx, intr.fy, intr.cx, intr.cy)
    return p_surf, grad, nearest, found


def _ring_patches(attr9: torch.Tensor, radius: int, rows: slice, w: int) -> torch.Tensor:
    """(rows*W, n_taps, 9) ring-ordered window of the padded attr image for
    the image rows ``rows``."""
    h0, h1 = rows.start, rows.stop
    taps = [attr9[h0 + radius + dy:h1 + radius + dy, radius + dx:radius + dx + w]
            for dy, dx in ring_taps(radius)]
    return torch.stack(taps, dim=2).reshape((h1 - h0) * w, len(taps), 9)


class RaycastStats(NamedTuple):
    """Per-pixel work of the ray cast, (H, W) int tensors."""
    n_sel: torch.Tensor    # selected taps (stable, capped at K)
    n_eval: torch.Tensor   # evaluations of f: f0, the ladder up to the bracket, refinement
    n_visit: torch.Tensor  # ring-ordered taps tested until K are selected


def _refine_evals(fp: int, bis: int, ksec_b: int, ksec_p: int) -> int:
    """Evaluations of f in the root refinement (the same for every pixel)."""
    return fp if fp > 0 else (ksec_b * ksec_p if ksec_b > 1 else bis)


def raycast_kernel_evals(stats: RaycastStats, cfg: SLAMConfig) -> torch.Tensor:
    """(H, W) evaluations of f that the CUDA kernel makes where the plain
    version makes ``stats.n_eval``: its ladder and its k-section evaluate
    ``RAYCAST_LADDER_BATCH`` points per pass over the taps, so a pass that
    brackets early, or the last one, evaluates up to that many - 1 extra;
    a pixel with no selected tap evaluates nothing."""
    _, fp, bis, ksec_b, ksec_p = _variant(cfg)
    G = RAYCAST_LADDER_BATCH
    refine = _refine_evals(fp, bis, ksec_b, ksec_p)
    ladder = stats.n_eval - 1 - refine
    if fp <= 0 and ksec_b > 1:
        refine = -(-ksec_b // G) * G * ksec_p
    done = 1 + (-(-ladder // G)) * G + refine
    return torch.where(stats.n_sel > 0, done, 0)


def raycast_core_ref(attr9: torch.Tensor, intr: CameraIntrinsics, cfg: SLAMConfig,
                     stats: bool = False, top: int = 0, height: int | None = None,
                     row0: int = 0):
    """Plain PyTorch version of ``raycast_core`` (same semantics, the same
    slab arguments, vectorised over (pixels, 49 taps) in chunks of whole
    image rows holding about ``cfg.raycast_chunk`` pixels).  With
    ``stats``, a fifth output: the per-pixel work, ``RaycastStats``."""
    ladder, fp, bis, ksec_b, ksec_p = _variant(cfg)
    refine = _refine_evals(fp, bis, ksec_b, ksec_p)
    R = cfg.predict_window_multiplier
    K = cfg.predict_max_neighbors
    kmin = cfg.predict_min_neighbors
    h, w = _slab_rows(attr9, intr, top, height, row0), intr.width
    dev = attr9.device
    ap = torch.nn.functional.pad(attr9, (0, 0, R, R, R, R))
    lad = const(ladder, dev)
    lad_prev = const([0.0] + ladder[:-1], dev)

    outs = []
    rows_per_chunk = max(1, min(h, cfg.raycast_chunk // w))
    for r0 in range(0, h, rows_per_chunk):
        r1 = min(h, r0 + rows_per_chunk)
        nb = _ring_patches(ap, R, slice(top + r0, top + r1), w)   # (C, T, 9)
        yy = torch.arange(row0 + r0, row0 + r1, dtype=torch.float32,
                          device=dev)[:, None].expand(r1 - r0, w)
        xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(r1 - r0, w)
        rx = ((xx - intr.cx) / intr.fx).reshape(-1)
        ry = ((yy - intr.cy) / intr.fy).reshape(-1)
        rn = torch.rsqrt(rx * rx + ry * ry + 1.0)
        ray = torch.stack([rx * rn, ry * rn, rn], dim=-1)      # (C, 3)

        pos, nrm = nb[..., 0:3], nb[..., 3:6]
        ok = ((nb[..., 8] > 0.5) & (pos[..., 2] > 0.1)
              & (nrm[..., 0] * nrm[..., 0] + nrm[..., 1] * nrm[..., 1]
                 + nrm[..., 2] * nrm[..., 2] > 0.01)
              & (nb[..., 6] >= cfg.predict_conf_threshold) & (nrm[..., 2] > 0.0))
        n_ok = torch.cumsum(ok.to(torch.int32), dim=1)
        sel = ok & (n_ok - 1 < K)
        n_sel = sel.sum(dim=1)
        # the walk stops at the K-th selected tap
        kth = torch.argmax((n_ok >= K).to(torch.int32), dim=1) + 1
        n_visit = torch.where(n_ok[:, -1] >= K, kth, n_ok.shape[1]) if K > 0 else 0 * n_sel
        proj = torch.abs(pos[..., 0] * ray[:, 0:1] + pos[..., 1] * ray[:, 1:2]
                         + pos[..., 2] * ray[:, 2:3])
        t0 = torch.where(sel, proj, 1e6).amin(dim=1)
        # the field sums over the (at most K) selected taps only: compact
        # them, in ring order, to the front (unselected taps add nothing)
        order = torch.argsort((~sel).to(torch.uint8), dim=1, stable=True)[:, :min(K, ok.shape[1])]
        sel = torch.gather(sel, 1, order)
        pos = torch.gather(pos, 1, order[..., None].expand(-1, -1, 3))
        nrm = torch.gather(nrm, 1, order[..., None].expand(-1, -1, 3))
        c = 10.0 * nrm
        T2 = torch.gather(nb[..., 7], 1, order) ** 2
        iT2 = 1.0 / torch.clamp(T2, min=1e-12)

        def field(ts):
            """f at ts * ray, ts (C, L) -> (f (C, L), support count)."""
            q = ts[..., None] * ray[:, None, :]                # (C, L, 3)
            v = q[:, :, None, :] - pos[:, None]                # (C, L, T, 3)
            d2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
            r = torch.sqrt(d2 * iT2[:, None])
            s = torch.clamp(1.0 - r, min=0.0)
            vc = (v[..., 0] * c[:, None, :, 0] + v[..., 1] * c[:, None, :, 1]
                  + v[..., 2] * c[:, None, :, 2])
            m = sel[:, None] & (d2 < T2[:, None])
            f = torch.where(m, 20.0 * (s * s * s) * iT2[:, None] * vc, 0.0).sum(dim=2)
            return f, m.sum(dim=2)

        f0, ncnt = field(t0[:, None])
        f0, ncnt = f0[:, 0], ncnt[:, 0]
        enough = (n_sel > kmin) & (ncnt > kmin)
        go_back = f0 > 0
        sgn = torch.where(go_back, -1.0, 1.0)
        t_i = t0[:, None] + sgn[:, None] * lad                 # (C, G)
        t_p = t0[:, None] + sgn[:, None] * lad_prev
        fv, _ = field(t_i)
        f_prev = torch.cat([f0[:, None], fv[:, :-1]], dim=1)
        hit = fv * sgn[:, None] > 0
        fnd = hit.any(dim=1)
        first = torch.argmax(hit.to(torch.int32), dim=1, keepdim=True)   # first True

        def at(x):
            return torch.gather(x, 1, first)[:, 0]

        gb = go_back
        t_lo = torch.where(fnd, torch.where(gb, at(t_i), at(t_p)), 1e6)
        t_hi = torch.where(fnd, torch.where(gb, at(t_p), at(t_i)), 1e6)
        f_lo = torch.where(fnd, torch.where(gb, at(fv), at(f_prev)), 0.0)
        f_hi = torch.where(fnd, torch.where(gb, at(f_prev), at(fv)), 0.0)
        found = enough & fnd
        n_eval = 1 + torch.where(fnd, first[:, 0] + 1, len(ladder)) + refine

        def falsi_point(lo, hi, flo, fhi):
            den = fhi - flo
            den = torch.where(torch.abs(den) > 1e-30, den, 1e-30)
            return torch.minimum(torch.maximum(lo - flo * (hi - lo) / den,
                                               torch.minimum(lo, hi)),
                                 torch.maximum(lo, hi))

        if fp > 0:
            for _ in range(fp):
                mid = falsi_point(t_lo, t_hi, f_lo, f_hi)
                fm = field(mid[:, None])[0][:, 0]
                neg = fm < 0
                t_lo, f_lo = torch.where(neg, mid, t_lo), torch.where(neg, fm, f_lo)
                t_hi, f_hi = torch.where(neg, t_hi, mid), torch.where(neg, f_hi, fm)
            t_surf = falsi_point(t_lo, t_hi, f_lo, f_hi)
        elif ksec_b > 1:
            frac = torch.arange(1, ksec_b + 1, dtype=torch.float32, device=dev)
            for _ in range(ksec_p):
                wdt = (t_hi - t_lo) * (1.0 / (ksec_b + 1.0))
                fs = field(t_lo[:, None] + wdt[:, None] * frac)[0]      # (C, B)
                # invariant f(t_lo) < 0 <= f(t_hi): the crossing lies after
                # the last negative interior point
                t_lo = t_lo + (fs < 0).sum(dim=1).to(torch.float32) * wdt
                t_hi = t_lo + wdt
            t_surf = 0.5 * (t_lo + t_hi)
        else:
            for _ in range(bis):
                mid = 0.5 * (t_lo + t_hi)
                neg = field(mid[:, None])[0][:, 0] < 0
                t_lo, t_hi = torch.where(neg, mid, t_lo), torch.where(neg, t_hi, mid)
            t_surf = 0.5 * (t_lo + t_hi)
        p_surf = t_surf[:, None] * ray                          # (C, 3)

        v = p_surf[:, None, :] - pos                            # (C, T, 3)
        d2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
        r = torch.sqrt(d2 * iT2)
        safe_r = torch.clamp(r, min=1e-20)
        s = torch.clamp(1.0 - r, min=0.0)
        vc = v[..., 0] * c[..., 0] + v[..., 1] * c[..., 1] + v[..., 2] * c[..., 2]
        a = -20.0 * (s * s * s) * iT2
        b = 60.0 * (s * s / safe_r) * (iT2 * iT2)
        m = sel & (d2 <= T2) & (d2 > 0.0)
        z0 = sel & (d2 == 0.0)
        g = torch.where(m[..., None], a[..., None] * c + (b * vc)[..., None] * v, 0.0)
        g = g + torch.where(z0[..., None], (-20.0 * iT2)[..., None] * c, 0.0)
        grad = -g.sum(dim=1)
        d2n = torch.where(sel, d2, 1e12)
        best = d2n.amin(dim=1, keepdim=True)
        # first (ring-order) tap holding the minimum; 0 when none beats the
        # 1e12 start
        first_min = torch.gather(order, 1, torch.argmax((d2n == best).to(torch.int32), dim=1,
                                                        keepdim=True))[:, 0]
        nearest = torch.where(best[:, 0] < 1e12, first_min, 0).to(torch.int32)
        outs.append((p_surf, grad, nearest, found, n_sel, n_eval, n_visit))

    p_surf, grad, nearest, found, *work = (torch.cat(o, dim=0) for o in zip(*outs))
    out = (p_surf.reshape(h, w, 3), grad.reshape(h, w, 3),
           nearest.reshape(h, w), found.reshape(h, w))
    return (*out, RaycastStats(*(x.reshape(h, w) for x in work))) if stats else out
