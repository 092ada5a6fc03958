"""API reference generator (role match: /root/reference/docs/Doxyfile +
docs/src/*.rst — the reference builds doxygen/sphinx API pages; this
environment has neither, so the pages are generated by introspection
into docs/api/*.md and built in the CI docs stage).

Usage: python docs/gen_api.py [--check]

``--check`` exits non-zero when the committed pages are stale (CI runs
this so the rendered reference always matches the code).
"""

import importlib
import inspect
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

PACKAGE = "ska_sdp_func_jax"
SUBPACKAGES = [
    "",                      # top-level exports
    "grid_data",
    "fourier_transforms",
    "visibility",
    "clean",
    "numeric_functions",
    "station_beam",
    "pipeline",
    "parallel",
    "kernels",
    "utility",
    "native",
]
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "api")


def _public_names(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")]
    out = []
    for n in names:
        try:
            obj = getattr(mod, n)
        except Exception:
            continue
        if inspect.ismodule(obj):
            continue
        out.append((n, obj))
    return out


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj, indent=""):
    doc = inspect.getdoc(obj)
    if not doc:
        return indent + "*(undocumented)*\n"
    return "\n".join(indent + line for line in doc.splitlines()) + "\n"


def _render_module(qualname):
    mod = importlib.import_module(qualname)
    lines = [f"# `{qualname}`", ""]
    lines.append(_doc(mod))
    lines.append("")
    for name, obj in _public_names(mod):
        if inspect.isclass(obj):
            lines.append(f"## class `{name}{_signature(obj)}`")
            lines.append("")
            lines.append(_doc(obj))
            for mname, meth in inspect.getmembers(obj):
                if mname.startswith("_") or not callable(meth):
                    continue
                if inspect.isbuiltin(meth):
                    continue
                owner = getattr(meth, "__qualname__", "")
                if not owner.startswith(obj.__name__ + "."):
                    continue   # inherited / foreign
                lines.append(
                    f"### `{name}.{mname}{_signature(meth)}`")
                lines.append("")
                lines.append(_doc(meth))
            lines.append("")
        elif callable(obj):
            lines.append(f"## `{name}{_signature(obj)}`")
            lines.append("")
            lines.append(_doc(obj))
            lines.append("")
        else:
            lines.append(f"## `{name}` = `{obj!r}`")
            lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def main():
    check = "--check" in sys.argv
    os.makedirs(OUT_DIR, exist_ok=True)
    index = ["# ska_sdp_func_jax API reference", "",
             "Generated by `python docs/gen_api.py` (CI docs stage "
             "verifies freshness with `--check`).", ""]
    stale = []
    for sub in SUBPACKAGES:
        qual = PACKAGE if not sub else f"{PACKAGE}.{sub}"
        fname = (sub or "index_top") + ".md"
        path = os.path.join(OUT_DIR, fname)
        content = _render_module(qual)
        index.append(f"- [`{qual}`]({fname})")
        if check:
            old = open(path).read() if os.path.exists(path) else ""
            if old != content:
                stale.append(fname)
        else:
            with open(path, "w") as f:
                f.write(content)
    index_md = "\n".join(index) + "\n"
    ipath = os.path.join(OUT_DIR, "README.md")
    if check:
        old = open(ipath).read() if os.path.exists(ipath) else ""
        if old != index_md:
            stale.append("README.md")
        if stale:
            print("stale API docs (rerun python docs/gen_api.py):",
                  ", ".join(stale))
            sys.exit(1)
        print("API docs up to date")
    else:
        with open(ipath, "w") as f:
            f.write(index_md)
        print(f"wrote {len(SUBPACKAGES) + 1} pages to {OUT_DIR}")


if __name__ == "__main__":
    main()
