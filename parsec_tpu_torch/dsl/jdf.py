"""JDF front-end — compile ``.jdf`` files to PTG taskpools.

The port of :mod:`parsec_tpu.dsl.jdf`.  The reference ships an
ahead-of-time compiler, ``parsec_ptgpp``, that turns ``.jdf`` sources into
C task-class tables (``parsec/interfaces/ptg/ptg-compiler/``: flex lexer
``parsec.l``, bison grammar ``parsec.y``, AST ``jdf.h``, codegen
``jdf2c.c``).  This module is its equivalent: the same surface grammar,
parsed here, lowered onto the runtime PTG builder
(:mod:`parsec_tpu_torch.dsl.ptg`), with **Python** as the host language of
expressions and BODY blocks instead of C.

Grammar accepted (reference ``parsec.y`` production names in parens):

* ``extern "C" %{ ... %}`` / bare ``%{ ... %}`` prologue blocks
  (*EXTERN_DECL*) — here Python code, executed once per compile into a
  namespace whose names are visible to every expression and BODY;
* global declarations ``NAME [ type = ... default = ... hidden = on ]``
  (*jdf_global_entry*) — taskpool constructor arguments; a ``default``
  property makes them optional;
* ``%option key = value`` lines (*jdf_option*);
* task classes (*jdf_function_entry*)::

      task(k, n) [ high_priority = on ]
        k = 0 .. NT-1          // parameter range (execution space)
        m = k % 4              // derived definition, usable below
        n = 0 .. m
        : A(m, n)              // affinity / owner-computes partitioning
        RW  X <- (k == 0) ? A(m, n) : X task(k-1, n)  [ type = FULL ]
              -> (k < NT-1) ? X task(k+1, n) : A(m, n)
        CTL c <- c other(0 .. m)
        ; k * 10 + n           // priority expression
        BODY [type=CUDA]
          return X + 1.0
        END
        BODY
          X += 1.0
        END

  Flow modes: ``RW``/``READ``/``WRITE``/``CTL`` (also ``IN``/``OUT``/
  ``INOUT`` aliases).  Dependency syntax — guards, ternaries, ranges,
  ``NEW``/``NONE`` targets, ``[key = value]`` property blocks — is the
  PTG dep grammar, shared verbatim with :mod:`parsec_tpu_torch.dsl.ptg`.

BODY blocks are Python: flows (numpy arrays on the CPU, torch tensors on
the device), parameters, definitions and scalar globals are in scope by
name, and so is every name of the prologue.  CPU bodies mutate flows in
place or ``return`` replacement values for the writable flows; a
``[type=CUDA]`` body (also ``HIP`` and ``LEVEL_ZERO``, the reference's
accelerator spellings) is a functional torch body, like
:mod:`parsec_tpu_torch.ops.tiles`'s, returning fresh tensors for the
writable flows in declaration order; the CUDA device module runs it.

``[type=TPU]`` bodies — the ``jnp`` incarnations of the JAX package's
``.jdf`` files — are kept under device type ``tpu``, which no device
module of the port serves: they compile to functions that are never
selected, so their code never runs and JAX is never imported.  A class
whose only BODY is ``tpu`` has no incarnation here.

Inline ``%{ expr %}`` escapes inside definitions and property values are
accepted and treated as plain (Python) expressions, mirroring the
reference's inline-C escapes.

Entry points: :func:`compile_jdf` (text → :class:`JDF`), ``JDF.new(...)``
(instantiate a taskpool), and :mod:`parsec_tpu_torch.dsl.jdfc` (the CLI
code generator, ``parsec_ptgpp`` analogue, emitting a Python module).
:meth:`JDF.verify` runs the graph linter (:mod:`parsec_tpu_torch.analysis`).
"""

from __future__ import annotations

import re
import textwrap
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .ptg import CTL, IN, INOUT, OUT, PTG

_MODES = {
    "RW": INOUT, "INOUT": INOUT,
    "READ": IN, "IN": IN,
    "WRITE": OUT, "OUT": OUT,
    "CTL": CTL,
}

_DEVICE_ALIASES = {
    "": "cpu", "CPU": "cpu", "TPU": "tpu", "RECURSIVE": "cpu",
    # the reference's accelerator spellings all run on the CUDA device
    # module; TPU bodies keep a device type no module serves
    "CUDA": "cuda", "HIP": "cuda", "LEVEL_ZERO": "cuda",
}


# ---------------------------------------------------------------------------
# AST (reference jdf.h: jdf_t / jdf_global_entry_t / jdf_function_entry_t)
# ---------------------------------------------------------------------------

@dataclass
class JDFGlobal:
    name: str
    props: Dict[str, str] = field(default_factory=dict)

    @property
    def has_default(self) -> bool:
        return "default" in self.props

    @property
    def is_collection(self) -> bool:
        """Collections are not passed into bodies (only scalar globals
        are — reference bodies see them as C globals); detected from the
        declared type (reference JDFs say "parsec_data_collection_t*",
        "parsec_tiled_matrix_t*"; ours say "collection")."""
        t = self.props.get("type", "").strip().strip('"').lower()
        return "collection" in t or "matrix" in t or t.endswith("*")


@dataclass
class JDFBody:
    code: str
    props: Dict[str, str] = field(default_factory=dict)
    line: int = 0

    @property
    def device(self) -> str:
        t = self.props.get("type", "")
        return _DEVICE_ALIASES.get(t.upper(), t.lower())


@dataclass
class JDFFlow:
    mode: str                       # key into _MODES
    name: str
    deps: List[str] = field(default_factory=list)   # "<- ..." / "-> ..." strings


@dataclass
class JDFTaskClass:
    name: str
    params: List[str]
    props: Dict[str, str] = field(default_factory=dict)
    decls: List[Tuple[str, str]] = field(default_factory=list)  # (name, expr src)
    partitioning: Optional[str] = None
    flows: List[JDFFlow] = field(default_factory=list)
    priority: Optional[str] = None
    bodies: List[JDFBody] = field(default_factory=list)


@dataclass
class JDFAst:
    name: str
    prologues: List[str] = field(default_factory=list)
    options: Dict[str, str] = field(default_factory=dict)
    globals: List[JDFGlobal] = field(default_factory=list)
    classes: List[JDFTaskClass] = field(default_factory=list)


class JDFSyntaxError(ValueError):
    def __init__(self, msg: str, line: int):
        super().__init__(f"jdf:{line}: {msg}")
        self.line = line


# ---------------------------------------------------------------------------
# lexing helpers
# ---------------------------------------------------------------------------

def _strip_comments(text: str) -> str:
    """Remove ``/* */`` and ``//`` comments (reference parsec.l) from the
    JDF structural text — but NOT inside ``%{ %}`` escapes (Python, where
    ``//`` is floor division), NOT inside ``BODY``…``END`` blocks (Python
    code), and NOT inside string literals.  Newlines are preserved so
    error line numbers stay accurate."""
    lines = text.split("\n")
    out: List[str] = []
    in_body = in_escape = in_comment = False
    for line in lines:
        if in_body:
            out.append(line)
            if line.strip() == "END":
                in_body = False
            continue
        if in_escape:
            out.append(line)
            if "%}" in line:
                in_escape = False
            continue
        # structural line: strip comments char-wise, respecting inline
        # %{ %} escapes and string literals
        buf: List[str] = []
        i, n = 0, len(line)
        while i < n:
            if in_comment:
                j = line.find("*/", i)
                if j < 0:
                    i = n
                else:
                    in_comment = False
                    i = j + 2
                continue
            if line.startswith("%{", i):
                j = line.find("%}", i + 2)
                if j < 0:  # escape continues on following lines
                    buf.append(line[i:])
                    in_escape = True
                    i = n
                else:
                    buf.append(line[i : j + 2])
                    i = j + 2
                continue
            if line.startswith("/*", i):
                j = line.find("*/", i + 2)
                if j < 0:
                    in_comment = True
                    i = n
                else:
                    i = j + 2
                continue
            if line.startswith("//", i):
                i = n
                continue
            if line[i] in "\"'":
                q = line[i]
                j = i + 1
                while j < n and line[j] != q:
                    j += 2 if line[j] == "\\" else 1
                buf.append(line[i : min(j + 1, n)])
                i = j + 1
                continue
            buf.append(line[i])
            i += 1
        stripped_line = "".join(buf)
        out.append(stripped_line)
        if (not in_comment and not in_escape
                and re.match(r"BODY(\s|\[|$)", stripped_line.strip())):
            in_body = True
    return "\n".join(out)


def _parse_props(src: str, line: int) -> Dict[str, str]:
    """``[ key = value key2 = "str" key3 = %{ expr %} ]`` → dict."""
    src = src.strip()
    if src.startswith("[") and src.endswith("]"):
        src = src[1:-1]
    props: Dict[str, str] = {}
    i, n = 0, len(src)
    while i < n:
        m = re.compile(r"\s*([A-Za-z_]\w*)\s*=\s*").match(src, i)
        if not m:
            if src[i:].strip():
                raise JDFSyntaxError(f"bad property text {src[i:]!r}", line)
            break
        key = m.group(1)
        i = m.end()
        if i < n and src[i] in "\"'":
            q = src[i]
            j = src.find(q, i + 1)
            if j < 0:
                raise JDFSyntaxError("unterminated string in properties", line)
            props[key] = src[i + 1 : j]
            i = j + 1
        elif src.startswith("%{", i):
            j = src.find("%}", i)
            if j < 0:
                raise JDFSyntaxError("unterminated %{ in properties", line)
            props[key] = src[i + 2 : j].strip()
            i = j + 2
        else:
            depth = 0
            j = i
            while j < n and (depth > 0 or not src[j].isspace()):
                if src[j] in "([":
                    depth += 1
                elif src[j] in ")]":
                    depth -= 1
                j += 1
            props[key] = src[i:j]
            i = j
    return props


def _inline_escapes(src: str) -> str:
    """``%{ expr %}`` inline escapes → the expression text itself (they are
    Python here, parenthesized to stay one term)."""
    return re.sub(r"%\{(.*?)%\}", lambda m: "(" + m.group(1).strip() + ")", src, flags=re.S)


_GLOBAL_RE = re.compile(r"^([A-Za-z_]\w*)\s*(\[.*\])?\s*$", re.S)
_HEADING_RE = re.compile(r"^([A-Za-z_]\w*)\s*\(([^)]*)\)\s*(\[.*\])?\s*$", re.S)
_DECL_RE = re.compile(r"^([A-Za-z_]\w*)\s*=\s*(.+)$", re.S)
_FLOW_RE = re.compile(r"^(RW|READ|WRITE|CTL|IN|OUT|INOUT)\s+([A-Za-z_]\w*)\s*(.*)$", re.S)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, text: str, name: str):
        self.ast = JDFAst(name)
        # physical lines of the comment-stripped source
        self.lines = _strip_comments(text).split("\n")
        self.pos = 0

    # -- line cursor -----------------------------------------------------
    def _peek(self) -> Optional[str]:
        while self.pos < len(self.lines):
            if self.lines[self.pos].strip():
                return self.lines[self.pos]
            self.pos += 1
        return None

    def _next(self) -> str:
        line = self._peek()
        if line is None:
            raise JDFSyntaxError("unexpected end of file", len(self.lines))
        self.pos += 1
        return line

    @property
    def lineno(self) -> int:
        return self.pos + 1

    # -- top level -------------------------------------------------------
    def parse(self) -> JDFAst:
        while self._peek() is not None:
            line = self._peek().strip()
            if line.startswith('extern "C" %{') or line.startswith("%{"):
                self._parse_prologue()
            elif line.startswith("%option"):
                self._next()
                body = line[len("%option"):].strip()
                m = _DECL_RE.match(body)
                if not m:
                    raise JDFSyntaxError(f"bad %option {body!r}", self.lineno)
                self.ast.options[m.group(1)] = m.group(2).strip()
            else:
                stmt, start_line = self._gather_stmt()
                hm = _HEADING_RE.match(stmt)
                if hm:
                    self._parse_task_class(hm, start_line)
                    continue
                gm = _GLOBAL_RE.match(stmt)
                if gm:
                    props = _parse_props(_inline_escapes(gm.group(2) or ""), start_line)
                    self.ast.globals.append(JDFGlobal(gm.group(1), props))
                    continue
                raise JDFSyntaxError(f"cannot parse {stmt!r}", start_line)
        return self.ast

    def _parse_prologue(self) -> None:
        line = self._next()
        idx = line.find("%{")
        rest = line[idx + 2:]
        end = rest.find("%}")
        if end >= 0:  # single-line %{ ... %} block
            self.ast.prologues.append(rest[:end].strip())
            return
        chunks = [rest]
        start = self.lineno
        while True:
            if self.pos >= len(self.lines):
                raise JDFSyntaxError("unterminated %{ block", start)
            raw = self.lines[self.pos]
            self.pos += 1
            end = raw.find("%}")
            if end >= 0:
                chunks.append(raw[:end])
                break
            chunks.append(raw)
        self.ast.prologues.append(textwrap.dedent("\n".join(chunks)))

    def _gather_stmt(self) -> Tuple[str, int]:
        """One logical statement: a line plus continuations while brackets
        are open (property blocks may span lines)."""
        start = self.lineno
        stmt = self._next().strip()
        while stmt.count("[") > stmt.count("]") or stmt.count("(") > stmt.count(")"):
            stmt += " " + self._next().strip()
        return stmt, start

    # -- task class ------------------------------------------------------
    def _parse_task_class(self, hm: re.Match, start_line: int) -> None:
        params = [p.strip() for p in hm.group(2).split(",") if p.strip()]
        props = _parse_props(_inline_escapes(hm.group(3) or ""), start_line)
        tc = JDFTaskClass(hm.group(1), params, props)

        # execution space: `name = range-or-expr` lines until `:` partitioning
        while True:
            stmt, ln = self._gather_stmt()
            if stmt.startswith(":"):
                tc.partitioning = _inline_escapes(stmt[1:].strip())
                break
            m = _DECL_RE.match(stmt)
            if not m:
                raise JDFSyntaxError(
                    f"expected `name = range` or `: partitioning`, got {stmt!r}", ln)
            tc.decls.append((m.group(1), _inline_escapes(m.group(2).strip())))
        declared = {n for n, _ in tc.decls}
        missing = [p for p in tc.params if p not in declared]
        if missing:
            raise JDFSyntaxError(
                f"task {tc.name}: parameters {missing} have no range", start_line)
        # task references (`X task(a, b)`) bind positionally to the heading:
        # declaration order of the parameter ranges must match it
        order = [n for n, _ in tc.decls if n in set(tc.params)]
        if order != tc.params:
            raise JDFSyntaxError(
                f"task {tc.name}: parameter ranges must be declared in "
                f"heading order {tc.params}, got {order}", start_line)

        # flows / priority, then bodies
        cur_flow: Optional[JDFFlow] = None
        while True:
            line = self._peek()
            if line is None:
                raise JDFSyntaxError(f"task {tc.name}: missing BODY", self.lineno)
            s = line.strip()
            if re.match(r"BODY(\s|\[|$)", s):
                break
            if s.startswith(";"):
                stmt, _ = self._gather_stmt()
                tc.priority = _inline_escapes(stmt[1:].strip())
                continue
            stmt, ln = self._gather_stmt()
            fm = _FLOW_RE.match(stmt)
            if fm:
                cur_flow = JDFFlow(fm.group(1), fm.group(2))
                tc.flows.append(cur_flow)
                rest = fm.group(3).strip()
                if rest:
                    self._add_deps(cur_flow, rest, ln)
            elif stmt.startswith("<-") or stmt.startswith("->"):
                if cur_flow is None:
                    raise JDFSyntaxError(f"dependency before any flow: {stmt!r}", ln)
                self._add_deps(cur_flow, stmt, ln)
            else:
                raise JDFSyntaxError(f"cannot parse flow line {stmt!r}", ln)

        while True:
            line = self._peek()
            if line is None or not re.match(r"BODY(\s|\[|$)", line.strip()):
                break
            tc.bodies.append(self._parse_body(tc))
        if not tc.bodies:
            raise JDFSyntaxError(f"task {tc.name}: no BODY", self.lineno)
        self.ast.classes.append(tc)

    def _add_deps(self, flow: JDFFlow, text: str, line: int) -> None:
        """Split a run of `<- ... -> ...` into individual dep strings."""
        text = _inline_escapes(text.strip())
        starts = [m.start() for m in re.finditer(r"<-|->", text)]
        # keep only depth-0 arrow markers (a `->` can't appear inside
        # expressions in this grammar, but be safe about brackets)
        depth0 = []
        depth = 0
        k = 0
        for i, ch in enumerate(text):
            if ch in "([":
                depth += 1
            elif ch in ")]":
                depth -= 1
            if k < len(starts) and i == starts[k]:
                if depth == 0:
                    depth0.append(i)
                k += 1
        if not depth0 or depth0[0] != 0:
            raise JDFSyntaxError(f"dependency must start with <- or ->: {text!r}", line)
        for a, b in zip(depth0, depth0[1:] + [len(text)]):
            flow.deps.append(text[a:b].strip())

    def _parse_body(self, tc: JDFTaskClass) -> JDFBody:
        line = self._next()
        s = line.strip()
        start = self.lineno
        props_src = s[len("BODY"):].strip()
        while props_src.count("[") > props_src.count("]"):
            props_src += " " + self._next().strip()
        props = _parse_props(_inline_escapes(props_src), start) if props_src else {}
        chunks: List[str] = []
        while True:
            if self.pos >= len(self.lines):
                raise JDFSyntaxError(f"task {tc.name}: BODY without END", start)
            raw = self.lines[self.pos]
            self.pos += 1
            if raw.strip() == "END":
                break
            # reference bodies are brace-wrapped C; tolerate a lone { or }
            if raw.strip() in ("{", "}"):
                continue
            chunks.append(raw)
        return JDFBody(textwrap.dedent("\n".join(chunks)), props, start)


# ---------------------------------------------------------------------------
# lowering to the PTG builder (the jdf2c analogue)
# ---------------------------------------------------------------------------

def scalar_globals_for(tc: JDFTaskClass, scalar_globals: List[str]) -> List[str]:
    """Scalar globals visible in this class's bodies: locals and flows
    shadow globals (C scoping: inner wins).  Single source of truth for
    both the runtime front-end and the jdfc code generator."""
    shadowed = {n for n, _ in tc.decls} | {f.name for f in tc.flows}
    return [n for n in scalar_globals if n not in shadowed]


def uses_this_task(code: str) -> bool:
    """True when the body code references the ``this_task`` identifier
    (real NAME tokens only — not comments or string literals)."""
    import io
    import tokenize

    try:
        for tok in tokenize.generate_tokens(io.StringIO(code).readline):
            if tok.type == tokenize.NAME and tok.string == "this_task":
                return True
        return False
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # un-tokenizable snippet: fall back to a plain word search
        return bool(re.search(r"\bthis_task\b", code))


def _compile_body(body: JDFBody, tc: JDFTaskClass, namespace: Dict[str, Any],
                  jdf_name: str, scalar_globals: Optional[List[str]] = None) -> Callable:
    """A BODY block → Python function over (flows, params, definitions,
    scalar globals) — reference bodies see JDF globals as C globals."""
    args = [f.name for f in tc.flows if _MODES[f.mode] != CTL]
    args += [n for n, _ in tc.decls]
    args += [n for n in (scalar_globals or []) if n not in args]
    if uses_this_task(body.code):
        # reference bodies use `this_task` (e.g. choice.jdf decrements
        # nb_tasks for the not-taken branch); CPU incarnations only — the
        # device module calls a body with tensors and values, and a graph
        # capture cannot hold a Task object
        if body.device != "cpu":
            raise ValueError(
                f"task {tc.name}: this_task is only available in CPU "
                "BODY incarnations")
        args.append("this_task")
    fname = f"_jdf_{tc.name}_{body.device}_body"
    src = f"def {fname}({', '.join(args)}):\n" + textwrap.indent(body.code or "pass", "    ")
    code = compile(src, f"<jdf:{jdf_name}:{tc.name}:BODY@{body.line}>", "exec")
    ns = dict(namespace)
    exec(code, ns)
    fn = ns[fname]
    fn._jdf_source = src
    return fn


class JDF:
    """A compiled JDF: AST + prologue namespace + the lowered :class:`PTG`.

    ``new(**globals)`` instantiates a taskpool — the analogue of the
    generated ``parsec_<name>_new(...)`` constructor (``jdf2c.c:4637``)."""

    def __init__(self, ast: JDFAst, namespace: Dict[str, Any]):
        self.ast = ast
        self.namespace = namespace
        self.ptg = self._lower()

    def _lower(self) -> PTG:
        ptg = PTG(self.ast.name)
        # prologue names (helpers, constants) visible to every expression
        ptg.constants.update(
            {k: v for k, v in self.namespace.items() if not k.startswith("__")})
        # globals with defaults are optional constructor args
        for g in self.ast.globals:
            if g.has_default:
                try:
                    # defaults see the prologue names AND earlier globals'
                    # defaults (ptg.constants accumulates in order)
                    ptg.constants[g.name] = eval(  # noqa: S307 - trusted source
                        g.props["default"], dict(ptg.constants))
                except Exception as e:
                    raise ValueError(
                        f"global {g.name}: bad default {g.props['default']!r}: {e}")
        scalar_globals = [g.name for g in self.ast.globals if not g.is_collection]
        for tc in self.ast.classes:
            pc = ptg.task_class(tc.name)
            pc.properties.update(tc.props)
            params = set(tc.params)
            for name, expr in tc.decls:
                if name in params:
                    pc.param(name, expr)
                else:
                    pc.define(name, expr)
            if tc.partitioning:
                pc.affinity(tc.partitioning)
            for f in tc.flows:
                pc.flow(f.name, _MODES[f.mode], *f.deps)
            body_globals = scalar_globals_for(tc, scalar_globals)
            pc.use_globals(*body_globals)
            if tc.priority:
                pc.priority(tc.priority)
            elif tc.props.get("high_priority", "").lower() in ("on", "yes", "true", "1"):
                # reference jdf property: boost the class above default-0
                # priority tasks (jdf2c honors it in the generated
                # priority expression)
                pc.priority(str(1 << 20))
            bodies: Dict[str, Callable] = {}
            for b in tc.bodies:
                dev = b.device
                if dev in bodies:
                    raise ValueError(
                        f"task {tc.name}: duplicate BODY for device {dev!r}")
                bodies[dev] = _compile_body(
                    b, tc, self.namespace, self.ast.name, body_globals)
                def hook_prop(prop: str):
                    """A BODY property naming a callable in the prologue
                    namespace (evaluate=/stage_in=/stage_out=)."""
                    expr = b.props.get(prop)
                    if not expr:
                        return None
                    try:
                        fn = eval(expr, dict(self.namespace))  # noqa: S307
                    except Exception as e:
                        raise ValueError(
                            f"task {tc.name}: BODY {prop}={expr!r}: {e}")
                    if not callable(fn):
                        raise ValueError(
                            f"task {tc.name}: BODY {prop}={expr!r} is not "
                            "callable")
                    return fn

                # reference BODY stage_in=/stage_out= properties
                # (stage_custom.jdf:185-186): custom device staging,
                # applied to every data flow of the class
                for prop, slot in (("stage_in", 0), ("stage_out", 1)):
                    hook = hook_prop(prop)
                    if hook is None:
                        continue
                    for f in tc.flows:
                        if _MODES[f.mode] == CTL:
                            continue
                        cur = pc.stage_hooks.get(f.name, (None, None))
                        pair = (hook, cur[1]) if slot == 0 else (cur[0], hook)
                        pc.stage(f.name, *pair)
                # reference BODY [evaluate = fn]: incarnation
                # applicability predicate (HOOK_RETURN_NEXT skips it)
                ev_fn = hook_prop("evaluate")
                if ev_fn is not None:
                    pc.evaluate_hook(dev, ev_fn)
            pc.body(**bodies)
        return ptg

    # ------------------------------------------------------------------
    def verify(self, globals_: Optional[Dict[str, Any]] = None, **kw):
        """Ahead-of-time graph verification of the compiled JDF (see
        ``PTG.verify``).  Without ``globals_`` only the static source-level
        checks run, judged against the declared JDF globals; with concrete
        globals the full instance checks (reciprocity, hazards, cycles,
        liveness) run.  Returns a list of findings (empty = clean)."""
        from ..analysis import lint_jdf

        return lint_jdf(self, globals_, **kw)

    def required_globals(self) -> List[str]:
        return [g.name for g in self.ast.globals if not g.has_default]

    def new(self, **globals_: Any):
        missing = [n for n in self.required_globals() if n not in globals_
                   and n not in self.ptg.constants]
        if missing:
            raise TypeError(f"{self.ast.name}.new(): missing globals {missing}")
        return self.ptg.taskpool(**globals_)


def compile_jdf(text: str, name: str = "jdf", namespace: Optional[Dict[str, Any]] = None) -> JDF:
    """Compile JDF source text. ``namespace`` seeds the prologue namespace
    (e.g. helper functions provided by the caller)."""
    ast = _Parser(text, name).parse()
    ns: Dict[str, Any] = dict(namespace or {})
    for chunk in ast.prologues:
        exec(compile(chunk, f"<jdf:{name}:prologue>", "exec"), ns)
    return JDF(ast, ns)


def compile_jdf_file(path: str, namespace: Optional[Dict[str, Any]] = None) -> JDF:
    with open(path) as f:
        text = f.read()
    name = re.sub(r"\W", "_", path.rsplit("/", 1)[-1].rsplit(".", 1)[0])
    return compile_jdf(text, name, namespace)
