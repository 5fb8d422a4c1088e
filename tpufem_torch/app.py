"""FEM-vs-AI comparison dashboard — port of ``app.py`` (parity with reference
app.py:461-542).

If gradio is installed: a Blocks dashboard with a case dropdown, four view modes
(Side-by-Side / FEM Only / AI Only / Error Map), two Model3D viewers, the
engineering report (incl. safety factor vs AL6061-T6 yield) and the stress
histogram. If gradio is absent: writes a static HTML dashboard per case using
<model-viewer> for the GLBs — the same artifacts, no server required
(analogous to the reference's app_deployment.py HF-Spaces variant). gradio is
imported only when the dashboard is served, never with the module.

    python -m tpufem_torch.app --data_root DIR [--static_out DIR]
"""

from __future__ import annotations

import argparse
import html as _html
import shutil
from pathlib import Path

from tpufem_torch.app_core import (
    VIEW_MODES,
    dynamics_entries,
    case_glbs,
    ai_status,
    engineering_report,
    list_cases,
    model_summary,
    stress_histogram_png,
)
from tpufem_torch.pipeline.config import get_paths


def has_gradio() -> bool:
    import importlib.util

    return importlib.util.find_spec("gradio") is not None


def build_gradio_app(paths, dynamics_dir=None):
    import gradio as gr

    cases = list_cases(paths)

    def on_change(case_id, view):
        glbs = case_glbs(paths, case_id, view)
        report = engineering_report(paths, case_id)
        png = stress_histogram_png(paths, case_id, paths.data / f"_hist_{case_id}.png")
        return (
            str(glbs["left"]) if glbs["left"] else None,
            str(glbs["right"]) if glbs["right"] else None,
            report,
            str(png) if png else None,
            ai_status(paths, case_id),
        )

    with gr.Blocks(title="tpufem — UAV wing FEM vs AI") as demo:
        gr.Markdown("# UAV wing structural analysis — FEM vs AI surrogate (tpufem)")
        with gr.Row():
            dd = gr.Dropdown(cases, value=cases[0] if cases else None, label="case")
            view = gr.Radio(VIEW_MODES, value=VIEW_MODES[0], label="view mode")
        with gr.Row():
            left = gr.Model3D(label="FEM")
            right = gr.Model3D(label="AI")
        report = gr.Markdown()
        hist = gr.Image(label="stress histogram (FEM vs AI)")
        status = gr.Markdown()
        gr.Markdown("## Model summary\n" + model_summary(paths))

        # Dynamics section (modal / buckling results under results/): no
        # reference counterpart — the reference app shows static results only
        dyn = dynamics_entries(dynamics_dir or Path("results"))
        if dyn:
            gr.Markdown("## Dynamics (modal / buckling / prestress)")
            gr.Markdown("  \n\n".join(f"### {e['label']}\n{e['summary']}"
                                      for e in dyn))
            mode_glbs = {f"{e['label']}/{g.name}": g for e in dyn
                         for g in e["glbs"]}
            if mode_glbs:
                names = list(mode_glbs)
                mode_dd = gr.Dropdown(names, value=names[0], label="mode shape")
                mode_view = gr.Model3D(label="mode (exaggerated deflection)")
                mode_dd.change(lambda n: str(mode_glbs[n]), [mode_dd],
                               [mode_view])
                demo.load(lambda: str(mode_glbs[names[0]]), None, [mode_view])

        for comp in (dd, view):
            comp.change(on_change, [dd, view], [left, right, report, hist, status])
        if cases:
            demo.load(lambda: on_change(cases[0], VIEW_MODES[0]), None,
                      [left, right, report, hist, status])
    return demo


_HTML_TMPL = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpufem — {case_id}</title>
<script type="module" src="https://ajax.googleapis.com/ajax/libs/model-viewer/3.4.0/model-viewer.min.js"></script>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; background:#14161a; color:#e6e6e6; }}
 model-viewer {{ width: 48%; height: 420px; background: #1d2026; border-radius: 8px; }}
 .row {{ display: flex; gap: 2%; }}
 table {{ border-collapse: collapse; }} td, th {{ border: 1px solid #444; padding: 4px 10px; }}
 img {{ max-width: 820px; background: white; border-radius: 6px; }}
 a {{ color: #7ab7ff; }}
</style></head><body>
<h1>tpufem — case {case_id}</h1>
<div class="row">
  <model-viewer src="{fem_glb}" camera-controls exposure="1.1"></model-viewer>
  {right_viewer}
</div>
{report_html}
{hist_img}
<p>{nav}</p>
</body></html>
"""


def _md_to_html(md: str) -> str:
    """Tiny markdown-ish renderer (headers, tables, bold/code) — keeps the
    fallback dependency-free."""
    out = []
    in_table = False
    for line in md.splitlines():
        if line.startswith("|"):
            cells = [c.strip() for c in line.strip("|").split("|")]
            if all(set(c) <= {"-"} for c in cells):
                continue
            tag = "th" if not in_table else "td"
            if not in_table:
                out.append("<table>")
                in_table = True
            out.append("<tr>" + "".join(f"<{tag}>{_html.escape(c)}</{tag}>" for c in cells) + "</tr>")
            continue
        if in_table:
            out.append("</table>")
            in_table = False
        if line.startswith("### "):
            out.append(f"<h3>{_html.escape(line[4:])}</h3>")
        elif line.startswith("## "):
            out.append(f"<h2>{_html.escape(line[3:])}</h2>")
        elif line.strip():
            t = _html.escape(line)
            while "**" in t:
                t = t.replace("**", "<b>", 1).replace("**", "</b>", 1)
            t = t.replace("`", "")
            out.append(f"<p>{t}</p>")
    if in_table:
        out.append("</table>")
    return "\n".join(out)


def build_static_site(paths, out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    cases = list_cases(paths)
    index_links = []
    for cid in cases:
        glbs = case_glbs(paths, cid, "Side-by-Side")
        assets = out_dir / cid
        assets.mkdir(exist_ok=True)
        fem_rel = pred_rel = None
        if glbs["left"]:
            shutil.copyfile(glbs["left"], assets / "fem.glb")
            fem_rel = f"{cid}/fem.glb"
        if glbs["right"]:
            shutil.copyfile(glbs["right"], assets / "pred.glb")
            pred_rel = f"{cid}/pred.glb"
        err = paths.fem_case(cid) / "wing_error.glb"
        if err.exists():
            shutil.copyfile(err, assets / "error.glb")
        png = stress_histogram_png(paths, cid, assets / "hist.png")
        right_viewer = (
            f'<model-viewer src="{pred_rel}" camera-controls exposure="1.1"></model-viewer>'
            if pred_rel
            else "<div><i>no AI prediction for this case</i></div>"
        )
        page = _HTML_TMPL.format(
            case_id=cid,
            fem_glb=fem_rel or "",
            right_viewer=right_viewer,
            report_html=_md_to_html(engineering_report(paths, cid))
            + f"<p><i>{_html.escape(ai_status(paths, cid))}</i></p>",
            hist_img=f'<img src="{cid}/hist.png">' if png else "",
            nav='<a href="index.html">back to index</a>',
        )
        (out_dir / f"{cid}.html").write_text(page)
        index_links.append(f'<li><a href="{cid}.html">{cid}</a></li>')

    index = (
        "<!doctype html><html><head><meta charset='utf-8'><title>tpufem dashboard</title>"
        "<style>body{font-family:system-ui;margin:2rem;background:#14161a;color:#e6e6e6}"
        "a{color:#7ab7ff}</style></head><body>"
        "<h1>tpufem — UAV wing FEM vs AI</h1>"
        f"<p>{_md_to_html(model_summary(paths))}</p>"
        f"<ul>{''.join(index_links)}</ul></body></html>"
    )
    (out_dir / "index.html").write_text(index)
    return out_dir / "index.html"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--static_out", default=None,
                    help="write a static HTML dashboard here instead of serving")
    ap.add_argument("--dynamics_dir", default="results",
                    help="directory scanned for modal/buckling outputs")
    ap.add_argument("--port", type=int, default=7860)
    args = ap.parse_args(argv)
    paths = get_paths(args.data_root)

    if args.static_out or not has_gradio():
        out = Path(args.static_out or (paths.data / "dashboard"))
        idx = build_static_site(paths, out)
        print(f"static dashboard written: {idx}")
        return 0

    demo = build_gradio_app(paths, Path(args.dynamics_dir))
    demo.launch(server_port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
