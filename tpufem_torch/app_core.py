"""Dashboard core: case discovery, engineering report, histograms — port of
``tpufem/app_core.py``.

Parity with reference app.py:87-391 (case dropdown from params.csv success rows,
engineering report markdown with material/safety-factor/FEM-vs-AI tables, stress
histogram) — factored out of the UI so it is unit-testable and shared by the
gradio app and the static-HTML fallback (gradio is not installed in this
environment; reference app_deployment.py plays the analogous role there).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tpufem_torch.pipeline.config import Paths
from tpufem_torch.pipeline.reports import read_csv_rows

# AL6061-T6 (reference app.py:32-34)
MATERIAL_NAME = "AL6061-T6"
YIELD_MPA = 276.0

VIEW_MODES = ["Side-by-Side", "FEM Only", "AI Only", "Error Map"]


def list_cases(paths: Paths) -> list[str]:
    """Success rows of params.csv, falling back to a FEM-dir scan
    (reference app.py:87-95 / app_deployment.py:88-113)."""
    rows = read_csv_rows(paths.data / "params.csv")
    ids = [r["case_id"] for r in rows if r.get("status") == "success"]
    if not ids and paths.fem.exists():
        ids = [d.name for d in sorted(paths.fem.iterdir())
               if (d / "surface_results.npz").exists()]
    # keep only cases with a FEM result to show
    return [c for c in dict.fromkeys(ids)
            if (paths.fem_case(c) / "fem_report.json").exists()]


def case_glbs(paths: Paths, case_id: str, view: str) -> dict[str, Path | None]:
    """GLB paths for a view mode (reference app.py:415-445)."""
    fem_dir = paths.fem_case(case_id)
    fem = fem_dir / "wing_result.glb"
    pred = fem_dir / "wing_pred.glb"
    err = fem_dir / "wing_error.glb"

    def ok(p: Path) -> Path | None:
        return p if p.exists() else None

    if view == "FEM Only":
        return {"left": ok(fem), "right": None}
    if view == "AI Only":
        return {"left": ok(pred), "right": None}
    if view == "Error Map":
        return {"left": ok(err), "right": None}
    return {"left": ok(fem), "right": ok(pred)}


def safety_factor_band(max_stress_mpa: float) -> tuple[float, str]:
    """Safety factor vs AL6061-T6 yield with SAFE/MARGINAL/YIELD-EXCEEDED bands
    (reference app.py:265-278)."""
    sf = YIELD_MPA / max(max_stress_mpa, 1e-9)
    if sf >= 1.5:
        return sf, "SAFE"
    if sf >= 1.0:
        return sf, "MARGINAL"
    return sf, "YIELD EXCEEDED"


def engineering_report(paths: Paths, case_id: str) -> str:
    """Markdown engineering report (reference app.py:149-303)."""
    lines = [f"## Case `{case_id}`"]

    params_p = paths.geometry_case(case_id) / "params.json"
    if params_p.exists():
        p = json.loads(params_p.read_text())["params"]
        lines += [
            "### Geometry",
            "| span [m] | chord [m] | sweep [deg] | t/c |",
            "|---|---|---|---|",
            f"| {p['span_m']:.3f} | {p['chord_m']:.3f} | {p['sweep_deg']:.1f} | {p['thickness_ratio']:.3f} |",
        ]

    lines += [
        "### Material",
        f"{MATERIAL_NAME}: E = 69 GPa, nu = 0.33, yield = {YIELD_MPA:.0f} MPa",
    ]

    fem_p = paths.fem_case(case_id) / "fem_report.json"
    max_mpa = None
    if fem_p.exists():
        rep = json.loads(fem_p.read_text())
        stats = rep.get("extra", {}).get("stress_stats", {}).get("masked_nodes", {})
        if stats:
            max_mpa = stats["max"] / 1e6
            lines += [
                "### FEM results (masked nodes)",
                "| max [MPa] | mean [MPa] | p95 [MPa] | p99 [MPa] |",
                "|---|---|---|---|",
                f"| {stats['max']/1e6:.2f} | {stats['mean']/1e6:.2f} "
                f"| {stats['p95']/1e6:.2f} | {stats['p99']/1e6:.2f} |",
            ]
        disp = rep.get("extra", {}).get("disp_stats", {})
        if disp:
            lines += [
                f"Max |displacement|: **{disp.get('max_abs_mm', 0):.3f} mm**; "
                f"mean tip-direction z: {disp.get('mean_z_mm', 0):.3f} mm",
            ]
        solver = rep.get("extra", {}).get("solver", {})
        if solver:
            lines += [
                f"Solver: {solver.get('iters')} PCG iterations, relative residual "
                f"{solver.get('rel_residual', 0):.2e}",
            ]

    inf_p = paths.fem_case(case_id) / "inference_report.json"
    if inf_p.exists():
        rep = json.loads(inf_p.read_text())
        mm = rep["metrics"]["masked_nodes"]
        lines += [
            "### AI surrogate vs FEM (masked nodes)",
            "| MAE [MPa] | RMSE [MPa] | max err [MPa] | rel MAE |",
            "|---|---|---|---|",
            f"| {mm['mae_pa']/1e6:.3f} | {mm['rmse_pa']/1e6:.3f} "
            f"| {mm['max_err_pa']/1e6:.3f} | {100*mm['rel_mae']:.2f}% |",
        ]

    if max_mpa is not None:
        sf, band = safety_factor_band(max_mpa)
        lines += [
            "### Structural assessment",
            f"Safety factor = yield / max stress = {YIELD_MPA:.0f} / {max_mpa:.2f} "
            f"= **{sf:.2f}** -> **{band}**",
        ]

    mesh_p = paths.mesh_case(case_id) / "mesh_report.json"
    if mesh_p.exists():
        rep = json.loads(mesh_p.read_text())
        ex = rep.get("extra", {})
        q = ex.get("quality", {})
        lines += [
            "### Mesh",
            f"{ex.get('num_nodes', '?')} nodes / {ex.get('num_tets', '?')} tets; "
            f"aspect ratio mean {q.get('aspect_ratio_mean', 0):.1f} "
            f"(p95 {q.get('aspect_ratio_p95', 0):.1f}); "
            f"AR<3 share {100*q.get('quality_ok_ratio', 0):.0f}%",
        ]

    return "\n".join(lines)


def stress_histogram_png(paths: Paths, case_id: str, out_path: Path) -> Path | None:
    """FEM-vs-AI stress histogram PNG (reference app.py:306-391).

    The AI distribution comes from `pred_results.npz` cached by the inference
    CLI (tpufem_torch.scripts.inference_gnn); shared bins so the two
    histograms compare directly. matplotlib is imported here, not with the
    module, and only this function needs it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("stress_histogram_png draws with matplotlib, which is not installed; "
                          "the rest of app_core works without it") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    npz_p = paths.fem_case(case_id) / "surface_results.npz"
    if not npz_p.exists():
        return None
    z = np.load(npz_p)
    vm = z["stress_vm"][z["loss_mask"]] / 1e6
    pred_p = paths.fem_case(case_id) / "pred_results.npz"
    pred = None
    if pred_p.exists():
        pz = np.load(pred_p)
        pred = pz["pred_pa"][pz["loss_mask"]] / 1e6
    fig, ax = plt.subplots(figsize=(7, 3.2), dpi=110)
    hi = max(float(vm.max()), float(pred.max()) if pred is not None else 0.0)
    bins = np.linspace(0.0, max(hi, 1e-9), 61)
    ax.hist(vm, bins=bins, alpha=0.65, label="FEM", color="#3366aa")
    if pred is not None:
        ax.hist(pred, bins=bins, alpha=0.55, label="AI prediction", color="#cc5533")
    ax.set_xlabel("von Mises stress [MPa] (masked nodes)")
    ax.set_ylabel("count")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def ai_status(paths: Paths, case_id: str) -> str:
    """One-line AI inference status for the dashboard panel
    (reference app.py:355-391's AI status text)."""
    inf_p = paths.fem_case(case_id) / "inference_report.json"
    if not inf_p.exists():
        return ("AI: no inference for this case (run python -m "
                "tpufem_torch.scripts.inference_gnn)")
    rep = json.loads(inf_p.read_text())
    mm = rep["metrics"]["masked_nodes"]
    return (
        f"AI: MAE {mm['mae_pa']/1e6:.3f} MPa ({100*mm['rel_mae']:.2f}% rel), "
        f"inference {rep.get('inference_time_ms', 0):.0f} ms"
    )


def model_summary(paths: Paths) -> str:
    """Training summary markdown from training_log.json (reference app.py:112-137)."""
    p = paths.models / "training_log.json"
    if not p.exists():
        return "_no trained model found_"
    log = json.loads(p.read_text())
    lines = [
        f"best epoch {log.get('best_epoch')} / {log.get('epochs_run')} run, "
        f"best val loss {log.get('best_val_loss', 0):.5f}, "
        f"total {log.get('total_time_s', 0):.0f}s",
    ]
    test = log.get("test")
    if test:
        lines.append(
            f"test MAE(masked) {test.get('mae_pa_masked', 0)/1e6:.3f} MPa, "
            f"rel {100*test.get('rel_mae_masked', 0):.2f}%"
        )
    return "  \n".join(lines)


def dynamics_entries(results_dir: Path) -> list[dict]:
    """Scan a results directory for modal/buckling analysis outputs.

    Each subdirectory holding a modal_report.json or buckling_report.json
    becomes one entry: {"label", "summary" (markdown), "glbs" (list[Path])}.
    Feeds the dashboard's Dynamics section — a capability with no reference
    counterpart (the reference app shows static results only)."""
    entries: list[dict] = []
    if not results_dir.exists():
        return entries
    for d in sorted(p for p in results_dir.iterdir() if p.is_dir()):
        modal_p = d / "modal_report.json"
        buck_p = d / "buckling_report.json"
        sweep_p = d / "prestress_sweep.json"
        nl_p = d / "nonlinear_report.json"
        if (not modal_p.exists() and not buck_p.exists()
                and not sweep_p.exists() and not nl_p.exists()):
            continue
        lines: list[str] = []
        if modal_p.exists():
            rep = json.loads(modal_p.read_text())
            freqs = ", ".join(f"{f:.1f}" for f in rep.get("freqs_hz", []))
            lines.append(
                f"**Modal** ({rep.get('n_dof', '?')} DOF, "
                f"{rep.get('sweeps', '?')} sweeps): f = [{freqs}] Hz"
            )
            if (d / "frf.json").exists():
                lines.append("tip FRF sweep available (frf.json)")
            if (d / "psd_response.json").exists():
                psd = json.loads((d / "psd_response.json").read_text())
                lines.append(
                    f"von Karman gust response: tip RMS "
                    f"{1e3 * psd.get('tip_rms_uz_m', 0):.2f} mm at sigma_w "
                    f"{psd.get('sigma_w_ms', 0):g} m/s (psd_response.json)"
                )
        if buck_p.exists():
            rep = json.loads(buck_p.read_text())
            lf = rep.get("load_factor")
            lines.append(
                f"**Buckling** ({rep.get('n_dof', '?')} DOF): critical load "
                f"factor {lf:.0f}x the {rep.get('pressure_pa', 0)/1e3:.0f} kPa "
                f"reference load" if lf else "**Buckling**: no positive factor"
            )
        if sweep_p.exists():
            rep = json.loads(sweep_p.read_text())
            fs = rep.get("freqs_hz", [])
            ps = rep.get("load_factors", [])
            if fs and ps:
                lines.append(
                    f"**Prestressed modal** ({rep.get('n_dof', '?')} DOF, "
                    f"lambda_cr {rep.get('lambda_cr') and round(rep['lambda_cr']) or '?'}): "
                    f"f1 {fs[0][0]:.1f} Hz at p=0 -> {fs[-1][0]:.1f} Hz at "
                    f"p={ps[-1]:.0f} (frequency-collapse curve, "
                    f"prestress_sweep.json)"
                )
        if nl_p.exists():
            rep = json.loads(nl_p.read_text())
            tip = rep.get("tip_deflection_m", {})
            lines.append(
                f"**Nonlinear statics** ({rep.get('n_dof', '?')} DOF, "
                f"{rep.get('pressure_pa', 0)/1e3:.0f} kPa): tip "
                f"{tip.get('nonlinear', 0):.3f} m vs linear "
                f"{tip.get('linear', 0):.3f} m "
                f"({tip.get('stiffening_pct', 0):+.2f}% membrane stiffening)"
            )
        glbs = (sorted(d.glob("mode_*.glb")) + sorted(d.glob("buckling_mode_*.glb"))
                + sorted(d.glob("wing_*_deformed.glb")))
        entries.append({"label": d.name, "summary": "  \n".join(lines), "glbs": glbs})
    return entries
