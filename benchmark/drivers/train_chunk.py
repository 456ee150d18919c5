"""Per-chunk training: the port's ``train.step.make_train_step`` called
once a step on a street chunk, views from the mix, every step
synchronised.

Set-up builds the one step object and its state from the seed and drives
it through its first ``check_steps`` steps by the window's own call, on
distinct views; it keeps what the check compares (each step's loss, the
first gradient as Adam took it, read back from Adam's first moment, and
each leaf's change over those steps) as per-leaf norms.  A few more steps
warm up, then the window goes on from that same state.
"""

from __future__ import annotations

import torch

from .. import scene
from ..reference import counting
from ..reference import train as ref_train
from ..traffic import Traffic

LEAVES = ref_train.LEAVES + ("exposure",)


def build_views(cfg: dict, g: torch.Generator, device) -> list:
    """The configuration's training views: each capture point looks along
    each face direction; targets are smooth random fields."""
    views = []
    h, w = cfg["height"], cfg["width"]
    lane = cfg["capture_lane_m"]
    for x in cfg["capture_x"]:
        y = float(torch.rand(1, generator=g, device=device)) * 2 * lane - lane
        for face in cfg["faces_deg"]:
            cam = scene.camera([x, y, cfg["capture_height"]],
                               torch.pi * face / 180.0,
                               torch.pi * cfg["face_pitch_deg"] / 180.0,
                               w, h, cfg["fovx_deg"], zfar=100.0)
            views.append(dict(
                index=len(views), camera=cam,
                gt=scene.smooth_field(g, 3, h, w, device),
                mono_invdepth=0.02 + 0.3 * scene.smooth_field(g, 1, h, w,
                                                              device),
                alpha_mask=torch.ones(1, h, w, device=device),
                depth_mask=torch.ones(1, h, w, device=device)))
    return views


def raw_rows(rows: dict) -> dict:
    """Activated scene rows -> the raw leaves training holds."""
    op = rows["opacities"].clamp(1e-6, 1 - 1e-6)
    return dict(xyz=rows["means"], features_dc=rows["sh"][:, :1].contiguous(),
                features_rest=rows["sh"][:, 1:].contiguous(),
                log_scales=torch.log(rows["scales"]), quats=rows["quats"],
                opacity_raw=torch.log(op / (1 - op))[:, None])


def make_inputs(cfg: dict, seed: int, device):
    g = scene.generator(seed, device)
    rows = raw_rows(scene.street_rows(g, cfg["n_gaussians"], cfg["sh_degree"],
                                      cfg["length"], cfg["half_width"],
                                      device))
    return rows, build_views(cfg, g, device)


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.traffic = Traffic(mix, seed, cfg["n_views"])
        self.n_check = mix["check_steps"]

    # -- the program --------------------------------------------------------
    def setup(self) -> None:
        from street_sparse_3dgs_tpu_torch.config import (OptimizationConfig,
                                                         PipelineConfig)
        from street_sparse_3dgs_tpu_torch.models.gaussians import (
            GaussianMeta, GaussianParams)
        from street_sparse_3dgs_tpu_torch.train.step import (init_state,
                                                             make_train_step)

        cfg, dev = self.cfg, self.device
        rows, views = make_inputs(cfg, self.seed, dev)
        self.views = views
        self.batches = [self._batch(v) for v in views]
        opt = {k: v for k, v in cfg["opt"].items() if k != "n_images"}
        pipe = raster_settings(cfg)
        n = cfg["n_gaussians"]
        meta = GaussianMeta(sh_degree=cfg["sh_degree"], capacity=n)
        self.step = make_train_step(
            meta, OptimizationConfig(**opt), PipelineConfig(**pipe),
            cfg["spatial_lr_scale"], sh_degree_schedule=False,
            use_trained_exp=True, random_background=True)
        params = GaussianParams(*(rows[k] for k in ref_train.LEAVES))
        self.state = init_state(params, torch.ones(n, dtype=torch.bool,
                                                   device=dev),
                                cfg["opt"]["n_images"])
        start = self.state
        self.i = 0
        self.losses = []
        self.begin_window()
        for k in range(self.n_check):
            aux = self.request()
            self.losses.append(float(aux["loss"]))
            if k == 0:
                st = self.state
                mu = dict(zip(ref_train.LEAVES, st.adam_state.mu),
                          exposure=st.exposure_adam.mu)
                self.grad_norms = leaf_norms(
                    {k2: v / (1 - ref_train.BETA1) for k2, v in mu.items()})
        end = self.state
        self.change_norms = leaf_norms({
            k: a - b for k, a, b in zip(
                LEAVES, (*end.params, end.exposure),
                (*start.params, start.exposure))})
        self.setup_counters = self.counters()
        del start, end, rows
        for _ in range(self.mix["warmup_steps"]):
            self.request()

    def _batch(self, v: dict):
        from street_sparse_3dgs_tpu_torch.core.camera import CameraParams
        from street_sparse_3dgs_tpu_torch.train.step import CameraBatch

        cam = camera_params(CameraParams, v["camera"], self.device)
        return CameraBatch(camera=cam, gt_image=v["gt"],
                           alpha_mask=v["alpha_mask"],
                           mono_invdepth=v["mono_invdepth"],
                           depth_mask=v["depth_mask"],
                           depth_reliable=torch.tensor(True, device=self.device),
                           image_index=torch.tensor(v["index"],
                                                    device=self.device))

    def request(self):
        r = self.traffic[self.i]
        self.i += 1
        bg = torch.as_tensor(r["bg"], dtype=torch.float32, device=self.device)
        self.state, aux = self.step(self.state, self.batches[r["view"]], bg=bg)
        over = torch.stack([aux["dup_overflow"], aux["tile_overflow"]])
        self.overflow = torch.maximum(self.overflow, over)
        self.skipped += aux["update_skipped"]
        return aux

    def snapshot(self) -> dict:
        """What a roofline count needs of the step about to run."""
        r = self.traffic[self.i]
        return {"params": self.state.params, "view": r["view"]}

    def count(self, snap: dict) -> dict:
        """The work of the step of ``snap`` (its rows and view) for the
        rooflines and the MFU."""
        p = snap["params"]
        op = torch.sigmoid(p.opacity_raw[:, 0])
        c = counting.count_passes(
            p.xyz, torch.exp(p.log_scales), p.quats, op,
            torch.cat([p.features_dc, p.features_rest], 1),
            self.views[snap["view"]]["camera"], self.cfg["sh_degree"],
            torch.zeros(3, device=self.device))
        c["param_elems"] = sum(x.numel() for x in p)
        return c

    def describe(self) -> dict:
        """The check steps' views and overflow counters."""
        return {"check_views": [self.traffic[k]["view"]
                                for k in range(self.n_check)],
                "check_step_counters": self.setup_counters}

    def begin_window(self) -> None:
        self.overflow = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.skipped = torch.zeros((), dtype=torch.int64, device=self.device)

    def counters(self) -> dict:
        """The largest overflow counters of a window step, and the steps
        whose update was skipped for tile overflow: failed requests."""
        dup, tile = (int(x) for x in self.overflow.tolist())
        return {"dup_overflow": dup, "tile_overflow": tile,
                "failed": int(self.skipped)}

    def end_to_end(self, latencies: list, window_s: float) -> dict:
        return {"train_step_ms": window_s / len(latencies) * 1e3}

    def release(self) -> None:
        self.state = self.step = self.batches = None

    # -- the check ----------------------------------------------------------
    def program_outputs(self) -> dict:
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms}

    def reference_outputs(self, tf32: bool = False,
                          loss_fn=ref_train.view_loss) -> dict:
        cfg = self.cfg
        rows, views = make_inputs(cfg, self.seed, self.device)
        reqs = [self.traffic[k] for k in range(self.n_check)]
        out = ref_train.run_steps(
            rows, [views[r["view"]] for r in reqs],
            [torch.as_tensor(r["bg"], dtype=torch.float32,
                             device=self.device) for r in reqs],
            cfg["opt"], cfg["spatial_lr_scale"], cfg["sh_degree"],
            self.n_check, tf32=tf32, loss_fn=loss_fn)
        change = {k: out["params"][k] - (rows[k] if k in rows else
                                         torch.eye(3, 4, device=self.device))
                  for k in LEAVES}
        return {"losses": out["losses"], "grad_norms": leaf_norms(out["grads"]),
                "change_norms": leaf_norms(change)}

    def compare(self, prog: dict, ref: dict, limits: dict) -> list:
        return compare_training(prog, ref, limits)

    def summary(self, prog: dict, ref: dict) -> dict:
        """Both sides' losses and per-leaf norms."""
        return {"program": prog, "reference": ref}


def compare_training(prog: dict, ref: dict, limits: dict) -> list:
    """[(name, value, limit)]: the worst relative loss gap of the checked
    steps, and by the worst leaf the gap of the first gradient's norm and
    of the change's norm, each over the larger of the reference leaf's
    norm and the median leaf's.  Leaves whose reference gradient is under
    a thousandth of the median leaf's are left out of both."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                      ref["losses"]))
    g_ref = ref["grad_norms"]
    med_g = sorted(g_ref.values())[len(g_ref) // 2]
    kept = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]

    def worst(p, r):
        med = sorted(r[k] for k in kept)[len(kept) // 2]
        return max(abs(p[k] - r[k]) / max(r[k], med) for k in kept)

    return [("loss_gap", loss_gap, limits["loss_gap"]),
            ("grad_norm_gap", worst(prog["grad_norms"], g_ref),
             limits["grad_norm_gap"]),
            ("change_norm_gap", worst(prog["change_norms"],
                                      ref["change_norms"]),
             limits["change_norm_gap"])]


def raster_settings(cfg: dict) -> dict:
    """The configuration's rasterizer settings."""
    r = dict(cfg["raster"])
    r["dup_tails"] = tuple(tuple(t) for t in r["dup_tails"])
    return r


def camera_params(cls, cam: dict, device):
    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return cls(viewmatrix=t(cam["view"]), projmatrix=t(cam["proj"]),
               campos=t(cam["campos"]), tan_fovx=t(cam["tan_fovx"]),
               tan_fovy=t(cam["tan_fovy"]), focal_x=t(cam["focal_x"]),
               focal_y=t(cam["focal_y"]), height=cam["height"],
               width=cam["width"])
