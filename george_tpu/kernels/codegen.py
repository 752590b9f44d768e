# -*- coding: utf-8 -*-
"""Kernel DSL compiler: YAML specs -> generated JAX kernel classes.

This is the in-tree analogue of the reference's build-time codegen pipeline
(``generate_kernels.py`` + ``templates/{kernels.h,kernels.py,parser.h}``): one
YAML file per kernel in ``george_tpu/kernels/specs/`` compiles into
``george_tpu/kernels/generated.py``.  Unlike the reference — whose generated
sources were hand-edited after generation (see SURVEY.md §2.3 drift warning) —
ALL kernels here are first-class DSL citizens: ``kind: custom`` specs
(LCM, WendlandC2) declare their implementing module and are re-exported, so
re-running codegen is always safe.

Differences from the reference DSL:

* ``value`` is a Python/JAX function body (in ``r2`` for stationary kernels,
  per-axis scalars ``x1``/``x2`` otherwise) instead of a C++ expression.
* No hand-derived ``grad`` blocks: hyperparameter and input gradients come
  from ``jax.jacfwd``/``jax.jacrev`` of the compiled pair function, so the
  DSL cannot express an inconsistent gradient.

Regenerate with::

    python -m george_tpu.kernels.codegen
"""

import os
import textwrap

import yaml

SPEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "specs")
OUTPUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "generated.py")

HEADER = '''\
# -*- coding: utf-8 -*-
"""AUTO-GENERATED by ``python -m george_tpu.kernels.codegen`` — do not edit.

Kernel classes compiled from the YAML specs in ``george_tpu/kernels/specs/``.
Reference parity: ``/root/reference/kernels/*.yml`` and the generated
``src/george/kernels.py`` / ``include/george/kernels.h``.
"""

import numpy as np
import jax.numpy as jnp

from ..modeling import Model
from ..metrics import Metric, Subspace
from .base import (
    StationaryKernel,
    NonStationaryKernel,
    safe_sqrt,
    M_PI,
)

'''

STATIONARY_INIT = '''\
    def __init__(self{param_args},
                 metric=None, metric_bounds=None, lower=True, block=None,
                 bounds=None, ndim=1, axes=None):
{const_setup}\
        if metric is None:
            raise ValueError("missing required parameter 'metric'")
        metric = Metric(metric, bounds=metric_bounds, ndim=ndim,
                        axes=axes, lower=lower)
        kwargs = dict({param_kwargs})
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _Base{name}(**kwargs)
        self._init_stationary(base, metric, block)
'''

NONSTATIONARY_INIT = '''\
    def __init__(self{param_args},
                 bounds=None, ndim=1, axes=None):
{const_setup}\
        subspace = Subspace(ndim, axes=axes)
        kwargs = dict({param_kwargs})
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _Base{name}(**kwargs)
        self._init_nonstationary(base, subspace)
'''


def load_specs():
    specs = []
    for fn in sorted(os.listdir(SPEC_DIR)):
        if not fn.endswith(".yml"):
            continue
        with open(os.path.join(SPEC_DIR, fn)) as f:
            spec = yaml.safe_load(f)
        spec.setdefault("params", [])
        spec.setdefault("constants", [])
        spec.setdefault("reparams", [])
        specs.append(spec)
    specs.sort(key=lambda s: s["kernel_type"])
    return specs


def render_value_fn(spec):
    """Render the pure value function for a spec."""
    name = spec["name"]
    params = spec["params"]
    constants = spec["constants"]
    fn_name = "_value_{0}".format(name.lower().replace("kernel", ""))
    args = ["r2"] if spec["kind"] == "stationary" else ["x1", "x2"]
    args += list(params) + list(constants)
    lines = ["def {0}({1}):".format(fn_name, ", ".join(args))]
    for rp in spec["reparams"]:
        lines.append("    {0} = {1}".format(rp["name"], rp["expr"]))
    body = textwrap.dedent(spec["value"]).strip("\n")
    for line in body.split("\n"):
        lines.append("    " + line if line.strip() else "")
    return fn_name, "\n".join(lines) + "\n"


def render_class(spec, fn_name):
    name = spec["name"]
    params = spec["params"]
    constants = spec["constants"]
    doc = textwrap.indent(
        textwrap.dedent(spec.get("doc", name)).strip(), "    "
    )

    out = []
    out.append("class _Base{0}(Model):".format(name))
    out.append(
        "    parameter_names = ({0})".format(
            "".join('"{0}", '.format(p) for p in params)
        )
    )
    out.append("")
    out.append("")
    # Public alias matching the reference surface, where the Base*Kernel
    # Model stubs are importable (``src/george/kernels.py:295-360``).
    out.append("Base{0} = _Base{0}".format(name))
    out.append("")
    out.append("")

    parent = (
        "StationaryKernel"
        if spec["kind"] == "stationary"
        else "NonStationaryKernel"
    )
    out.append("class {0}({1}):".format(name, parent))
    out.append('    r"""\n{0}\n    """'.format(doc))
    out.append("")
    out.append("    kernel_type = {0}".format(spec["kernel_type"]))
    out.append(
        "    _base_param_names = ({0})".format(
            "".join('"{0}", '.format(p) for p in params)
        )
    )
    out.append(
        "    _constant_names = ({0})".format(
            "".join('"{0}", '.format(c) for c in constants)
        )
    )
    out.append("    _value_fn = staticmethod({0})".format(fn_name))
    out.append("")

    param_args = "".join(", {0}=None".format(p) for p in params)
    param_args += "".join(", {0}=None".format(c) for c in constants)
    param_kwargs = ", ".join("{0}={0}".format(p) for p in params)
    const_setup = ""
    for c in constants:
        const_setup += (
            "        if {0} is None:\n"
            "            raise ValueError(\"missing required parameter "
            "'{0}'\")\n"
            "        self.{0} = float({0})\n".format(c)
        )
    template = (
        STATIONARY_INIT if spec["kind"] == "stationary" else NONSTATIONARY_INIT
    )
    out.append(
        template.format(
            name=name,
            param_args=param_args,
            param_kwargs=param_kwargs,
            const_setup=const_setup,
        )
    )
    return "\n".join(out)


def generate(output=OUTPUT):
    specs = load_specs()
    chunks = [HEADER]
    names = []
    custom = []
    for spec in specs:
        if spec["kind"] == "custom":
            custom.append(spec)
            continue
        names.append(spec["name"])
        fn_name, fn_src = render_value_fn(spec)
        chunks.append(fn_src)
        chunks.append("")
        chunks.append(render_class(spec, fn_name))
        chunks.append("")
    all_names = names + [s["name"] for s in custom]
    chunks.insert(
        1, "__all__ = [\n{0}]\n\n".format(
            "".join(
                '    "{0}",\n    "Base{0}",\n'.format(n) for n in names
            )
        )
    )
    src = "\n".join(chunks)
    with open(output, "w") as f:
        f.write(src)
    return all_names


def check():
    """Verify the checked-in generated source matches the specs (the
    anti-drift guard; exits nonzero on mismatch)."""
    import tempfile

    with tempfile.NamedTemporaryFile("r+", suffix=".py") as tmp:
        generate(output=tmp.name)
        tmp.seek(0)
        fresh = tmp.read()
    with open(OUTPUT) as f:
        current = f.read()
    return fresh == current


if __name__ == "__main__":
    import sys as _sys

    if "--check" in _sys.argv:
        if check():
            print("generated sources are in sync with the specs")
        else:
            print("DRIFT: generated.py does not match the YAML specs; "
                  "re-run `python -m george_tpu.kernels.codegen`")
            _sys.exit(1)
    else:
        generated = generate()
        print(
            "generated {0} kernels -> {1}".format(len(generated), OUTPUT)
        )
