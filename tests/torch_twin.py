"""Run a reference test module's cases against the port.

``port_module(ref)`` executes the source of the JAX package's test
module ``ref`` again, with every import of ``worldql_server_tpu`` pointed
at the module of the same path in ``worldql_server_tpu_torch`` (the
scenario clients of ``scenarios/client.py`` too). The bodies are the
reference's, line for line, so each case holds the port to exactly
what it holds the JAX package to.

``cases(ref, names)`` expands the named cases with their own
``parametrize`` values, and ``call(fn, params, request)`` runs one with
the fixtures its signature asks for. ``pin`` checks, on both packages,
an invariant that the port holds and the reference is known to break.
"""

from __future__ import annotations

import inspect
import re
import sys
import types

def port_module(ref, replace=()):
    """A module holding ``ref``'s functions, bound to the port. Each
    ``(old, new)`` pair of ``replace`` is substituted in the source
    first, where a case names something only the JAX package has (its
    ``tpu`` index)."""
    src = inspect.getsource(ref)
    for old, new in replace:
        assert old in src, old
        src = src.replace(old, new)
    src = re.sub(r"\bworldql_server_tpu\b", "worldql_server_tpu_torch", src)
    name = ref.__name__ + "_on_port"
    mod = types.ModuleType(name)
    mod.__file__ = ref.__file__
    # dataclasses and pickling look classes up by module name
    sys.modules[name] = mod
    exec(compile(src, ref.__file__, "exec"), mod.__dict__)
    return mod


def cases(ref, names):
    """``[(name, params)]`` for each named case of ``ref``, one entry
    per value set of its ``parametrize`` mark (an empty dict without
    one)."""
    out = []
    for name in names:
        fn = getattr(ref, name)
        marks = [m for m in getattr(fn, "pytestmark", ())
                 if m.name == "parametrize"]
        if not marks:
            out.append((name, {}))
            continue
        (mark,) = marks
        argnames = [a.strip() for a in mark.args[0].split(",")]
        for values in mark.args[1]:
            values = values if len(argnames) > 1 else (values,)
            out.append((name, dict(zip(argnames, values))))
    return out


def case_id(case):
    name, params = case
    if not params:
        return name
    return name + "[" + "-".join(str(v) for v in params.values()) + "]"


def call(fn, params, request):
    """Run a reference case: its parameters, plus each fixture its
    signature names."""
    kwargs = dict(params)
    for arg in inspect.signature(fn).parameters:
        if arg not in kwargs:
            kwargs[arg] = request.getfixturevalue(arg)
    return fn(**kwargs)


def pin(on_port: bool, on_reference: bool, invariant: str) -> None:
    """An invariant checked on both packages: the port holds it; the
    reference is known not to (its fault, which the port's copy fixes
    as a deliberate deviation listed in ROADMAP Queue C). A reference
    that comes to hold it fails here with a message that says so, so
    the fix is reported and the deviation can go, rather than read as a
    regression of the port."""
    assert on_port, f"the port breaks: {invariant}"
    assert not on_reference, (
        f"the JAX package now holds '{invariant}': its fault is fixed, "
        "so the port's deviation (ROADMAP Queue C) can go")
