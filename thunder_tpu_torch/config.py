"""Typed run configuration, read from the reference's JSON config files
(appsrc/thunder.cpp:119-218 readPara; the key strings are those of
include/Optimiser.h:80-453), with the fields and defaults of
thunder_tpu.config.ThunderConfig that the port uses.

``ThunderConfig.from_json`` accepts the reference's section layout
(Basic / Reference Mask / Advanced / Professional / Subtract), so the
demo configs (configs/demo_2D.json etc.) run unmodified; keys the port
does not use are ignored.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from thunder_tpu_torch.geometry.symmetry import Symmetry


@dataclass
class ThunderConfig:
    # --- Basic ---
    mode: str = "2D"                    # "2D" or "3D"
    g_search: bool = True               # Global Search
    l_search: bool = True               # Local Search
    c_search: bool = False              # CTF Search
    k: int = 1                          # Number of Classes
    size: int = 160                     # Size of Image
    pixel_size: float = 1.32            # Pixel Size (Angstrom)
    mask_radius: float = 80.0           # Radius of Mask on Images (Angstrom)
    trans_s: float = 10.0               # Estimated Translation (Pixel)
    init_res: float = 60.0              # Initial Resolution (Angstrom)
    global_search_res: float = 15.0     # Perform Global Search Under (Angstrom)
    sym: str = "C1"                     # Symmetry
    init_model: str = ""                # Initial Model
    db: str = "particles.thu"           # .thu file
    par_prefix: str = ""                # Path of Particles
    dst_prefix: str = "./"              # Path of Output
    core_fsc: bool = False              # Calculate FSC Using Core Region
    mask_fsc: bool = False              # Calculate FSC Using Masked Region
    par_gra: bool = False               # Particle Grading
    ref_auto_recentre: bool = True      # Auto-Recentre Reference

    # --- Reference Mask ---
    perform_mask: bool = False
    global_mask: bool = False
    mask_path: str = ""

    # --- Advanced ---
    iter_max: int = 100
    gold_standard: bool = True
    pf: int = 2
    mkb_alpha: float = 15.0             # MKB Kernel Smooth Factor
    mkb_a: float = 1.9                  # MKB Kernel Radius
    # insertion kernel, set through the API only (neither CLI nor JSON
    # names it): "trilinear" (the reference's default, Config.h:97) or
    # "mkb", the modified Kaiser-Bessel blob (Reconstructor.cpp:424-567)
    # with its own grid correction.  As in thunder_tpu, the blob takes
    # the default radius and smooth factor (constants.DEFAULT_MKB_A,
    # DEFAULT_MKB_ALPHA) whatever mkb_a and mkb_alpha read.
    reco_kernel: str = "trilinear"
    m_s: int = 10000                    # global sampling points (3D)
    m_s_2d: int = 100                   # global sampling points (2D)
    m_l_r: int = 125                    # local rotation support (3D)
    m_l_r_2d: int = 9                   # local rotation support (2D)
    m_l_t: int = 9                      # local translation support
    m_l_d: int = 9                      # local defocus support
    m_reco: int = 100                   # poses drawn per image in reconstruction
    ignore_res: float = 200.0           # Ignore Signal Under (Angstrom)
    sclCor_res: float = 40.0            # scale-correction resolution
    thres_cutoff_fsc: float = 0.143
    thres_report_fsc: float = 0.143
    group_scl: bool = False
    zero_mask: bool = True
    ctf_refine_s: float = 0.01          # CTF Refine Standard Deviation
    save_refs_each_iter: bool = True
    save_thu_each_iter: bool = True

    # --- Professional ---
    trans_search_factor: float = 1.0
    perturb_factor_s_global: float = 0.5
    perturb_factor_s_local: float = 0.5
    perturb_factor_s_ctf: float = 0.5
    skip_e: bool = False
    skip_m: bool = False
    skip_r: bool = False

    # --- Subtract ---
    subtract: bool = False              # Subtract Masked Region Reference From Images
    centre_region: str = ""             # Region Need to Be Centred

    # --- not in the reference config ---
    seed: int = 20260816
    # on several ranks, keep a 3D round's padded grids (F, T, W) as
    # z-slabs over the data axis once one passes this many MB
    # (recon/sharded.py; THUNDER held whole volumes a rank)
    vol_shard_min_mb: int = 512

    @property
    def mode_2d(self) -> bool:
        return self.mode.upper() == "2D"

    @property
    def n_rot_global(self) -> int:
        return self.m_s_2d if self.mode_2d else self.m_s

    @property
    def n_rot_local(self) -> int:
        return self.m_l_r_2d if self.mode_2d else self.m_l_r

    @property
    def max_r(self) -> int:
        # size/2 - CEIL(a) with the gridding kernel's a = 1.9
        # (Model::maxR, Model.cpp:191-194)
        return self.size // 2 - 2

    def res_a2p(self, res_a: float) -> int:
        """Angstrom resolution -> integer shell index."""
        return max(1, int(self.size * self.pixel_size / res_a))

    @property
    def r_init(self) -> int:
        # AROUND(resA2P(1/initRes)) + 1 (Optimiser.cpp:316)
        return round(self.size * self.pixel_size / self.init_res) + 1

    @property
    def r_global(self) -> int:
        """Global-search band: min(res, 0.25 maskRadius / (1 +
        nSym)^(1/3)), then AROUND(resA2P(.)) + 1 (Optimiser.cpp:298-304;
        the symmetry is ignored in 2D)."""
        n_sym = 0 if self.mode_2d else Symmetry(self.sym).n_elements
        res = min(self.global_search_res, 0.25 * self.mask_radius / (1 + n_sym) ** (1 / 3))
        r = round(self.size * self.pixel_size / res) + 1
        return max(1, min(self.max_r, r))

    @property
    def r_low(self) -> int:
        """Shell below which signal is ignored (rL; Ignore Signal Under)."""
        return max(1, int(self.size * self.pixel_size / self.ignore_res))

    @staticmethod
    def from_json(path: str) -> "ThunderConfig":
        with open(path) as f:
            raw = json.load(f)
        c = ThunderConfig()
        for section, keys in _JSON_KEYS.items():
            got = raw.get(section, {})
            for key, name in keys.items():
                if key in got:
                    setattr(c, name, got[key])
        return c


# section -> {reference key: field}
_JSON_KEYS = {
    "Basic": {
        "2D or 3D Mode": "mode",
        "Global Search": "g_search",
        "Local Search": "l_search",
        "CTF Search": "c_search",
        "Number of Classes": "k",
        "Size of Image": "size",
        "Pixel Size (Angstrom)": "pixel_size",
        "Radius of Mask on Images (Angstrom)": "mask_radius",
        "Estimated Translation (Pixel)": "trans_s",
        "Initial Resolution (Angstrom)": "init_res",
        "Perform Global Search Under (Angstrom)": "global_search_res",
        "Symmetry": "sym",
        "Initial Model": "init_model",
        ".thu File Storing Paths and CTFs of Images": "db",
        "Path of Particles": "par_prefix",
        "Path of Output": "dst_prefix",
        "Calculate FSC Using Core Region": "core_fsc",
        "Calculate FSC Using Masked Region": "mask_fsc",
        "Particle Grading": "par_gra",
        "Auto-Recentre Reference": "ref_auto_recentre",
    },
    "Reference Mask": {
        "Perform Reference Mask": "perform_mask",
        "Perform Reference Mask During Global Search": "global_mask",
        "Provided Mask": "mask_path",
    },
    "Advanced": {
        "Save Reference(s) Each Iteration": "save_refs_each_iter",
        "Save .thu File Each Iteration": "save_thu_each_iter",
        "Max Number of Iteration": "iter_max",
        "Using Golden Standard FSC": "gold_standard",
        "Padding Factor": "pf",
        "MKB Kernel Radius": "mkb_a",
        "MKB Kernel Smooth Factor": "mkb_alpha",
        "Number of Sampling Points for Scanning in Global Search (3D)": "m_s",
        "Number of Sampling Points for Scanning in Global Search (2D)": "m_s_2d",
        "Number of Sampling Points of Rotation in Local Search (3D)": "m_l_r",
        "Number of Sampling Points of Rotation in Local Search (2D)": "m_l_r_2d",
        "Number of Sampling Points of Translation in Local Search": "m_l_t",
        "Number of Sampling Points of Defocus in Local Search": "m_l_d",
        "Number of Sampling Points Used in Reconstruction": "m_reco",
        "Ignore Signal Under (Angstrom)": "ignore_res",
        "Correct Intensity Scale Using Signal Under (Angstrom)": "sclCor_res",
        "FSC Threshold for Cutoff Frequency": "thres_cutoff_fsc",
        "FSC Threshold for Reporting Resolution": "thres_report_fsc",
        "Grouping when Correcting Intensity Scale": "group_scl",
        "Mask Images with Zero Noise": "zero_mask",
        "CTF Refine Standard Deviation": "ctf_refine_s",
    },
    "Professional": {
        "Translation Search Factor": "trans_search_factor",
        "Perturbation Factor (Small, Global)": "perturb_factor_s_global",
        "Perturbation Factor (Small, Local)": "perturb_factor_s_local",
        "Perturbation Factor (Small, CTF)": "perturb_factor_s_ctf",
        "Skip Expectation": "skip_e",
        "Skip Maximization": "skip_m",
        "Skip Reconstruction": "skip_r",
    },
    "Subtract": {
        "Subtract Masked Region Reference From Images": "subtract",
        "Region Need to Be Centred": "centre_region",
    },
}
