"""The eight ozlint rules, over the port's tree.

Port of `ozone_tpu/tools/lint/rules.py`. Each rule guards an invariant
the repository states in prose and the reference has paid for in bugs:

- ``deadline-propagation``  every timeout in the client/net/lifecycle
  datapath and the codec service derives from ``resilience.Deadline``
  (the hard-coded 120 s connect class of bug).
- ``blocking-under-lock``   no blocking call while holding a lock
  (``Condition.wait`` is exempt: it releases the lock).
- ``fence-carrying-commit`` ring mutations of term-fenced state carry
  their fencing term / expected object id.
- ``dispatch-shape-stability`` a launch plan (an lru_cache'd factory of
  a device tensor or kernel argument) is never keyed on a per-call width,
  and one keyed on an erasure pattern has a finite bound. The reference
  watches `jax.jit` static arguments and jitted closure factories; the
  port compiles each kernel once, so what can thrash is the plan cache.
- ``error-swallowing``      no silently dropped exceptions on datapath
  or consensus modules.
- ``span-on-dispatch``      the codec's device edges (the kernel launch
  through the ctypes library, the pinned device-to-host copy, the CUDA
  event record and synchronize, and the `start_pull` / `finish_pull`
  helpers that wrap them) run inside an active trace span, and RPC
  handlers register only through `RpcServer.add_service`, whose worker
  opens the server span.
- ``datapath-no-copy``      the wire-facing datapath modules never
  materialize payload bytes.
- ``bounded-queue``         server-side packages construct no unbounded
  ``queue.Queue()``/``deque()``.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from ozone_tpu_torch.tools.lint.core import Finding, Rule, SourceFile, register

# --------------------------------------------------------- AST helpers


def dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression: ``socket.create_connection``,
    ``self._cond.wait`` -> empty string for non-name shapes."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def last_name(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def receiver_name(call_func: ast.AST) -> str:
    """For ``a.b.wait(...)`` the receiver's final segment (``b``)."""
    if isinstance(call_func, ast.Attribute):
        return last_name(call_func.value)
    return ""


def _span(node: ast.AST) -> tuple[int, int]:
    return (node.lineno, getattr(node, "end_lineno", node.lineno)
            or node.lineno)


class _ConstEnv:
    """Single-assignment numeric-constant environment: module-level and
    function-local ``NAME = 120.0`` style bindings, poisoned on
    reassignment so only provably-constant names resolve."""

    def __init__(self) -> None:
        self._vals: dict[str, Optional[float]] = {}

    def bind(self, name: str, value: Optional[float]) -> None:
        if name in self._vals:
            self._vals[name] = None  # reassigned: no longer provable
        else:
            self._vals[name] = value

    def get(self, name: str) -> Optional[float]:
        return self._vals.get(name)


def _fold(node: ast.AST, env: _ConstEnv) -> Optional[float]:
    """Resolve an expression to a numeric constant, through unary/binary
    arithmetic and single-assignment name bindings. None = not provable."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool) or not isinstance(
                node.value, (int, float)):
            return None
        return float(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.USub, ast.UAdd)):
        v = _fold(node.operand, env)
        if v is None:
            return None
        return -v if isinstance(node.op, ast.USub) else v
    if isinstance(node, ast.BinOp):
        a, b = _fold(node.left, env), _fold(node.right, env)
        if a is None or b is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.Div):
                return a / b
            if isinstance(node.op, ast.FloorDiv):
                return a // b
            if isinstance(node.op, ast.Pow):
                return a ** b
        except (ZeroDivisionError, OverflowError):
            return None
        return None
    if isinstance(node, ast.Name):
        return env.get(node.id)
    return None


def _scope_walk(body: Iterable[ast.stmt]):
    """Every node in this scope — including except-handler bodies, loop
    bodies, with-blocks — but NOT nested function/class scopes. Yields
    in SOURCE order (pre-order DFS): constant folding relies on seeing
    a name's first binding before its uses in later assignments."""
    stack = list(reversed(list(body)))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue  # separate scope
        stack.extend(reversed(list(ast.iter_child_nodes(node))))


def _collect_env(body: Iterable[ast.stmt], env: _ConstEnv,
                 *, recurse: bool = True) -> None:
    """Bind simple ``NAME = <expr>`` assignments (value folded eagerly;
    a second binding — or any dynamic one: loop targets, ``with … as``,
    except-handler rebinds, walrus — poisons the name, so partial
    knowledge never produces a false constant)."""
    nodes = _scope_walk(body) if recurse else list(body)
    for stmt in nodes:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            env.bind(stmt.targets[0].id, _fold(stmt.value, env))
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and isinstance(stmt.target, ast.Name):
            env.bind(stmt.target.id, _fold(stmt.value, env))
        elif isinstance(stmt, ast.AugAssign) and isinstance(
                stmt.target, ast.Name):
            env.bind(stmt.target.id, None)
        elif isinstance(stmt, ast.Assign):
            # tuple/starred/attribute targets: poison every plain name
            for t in stmt.targets:
                for nn in ast.walk(t):
                    if isinstance(nn, ast.Name):
                        env.bind(nn.id, None)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            for nn in ast.walk(stmt.target):
                if isinstance(nn, ast.Name):
                    env.bind(nn.id, None)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None:
                    for nn in ast.walk(item.optional_vars):
                        if isinstance(nn, ast.Name):
                            env.bind(nn.id, None)
        elif isinstance(stmt, ast.ExceptHandler) and stmt.name:
            env.bind(stmt.name, None)
        elif isinstance(stmt, ast.NamedExpr) and \
                isinstance(stmt.target, ast.Name):
            env.bind(stmt.target.id, None)


def _fn_env(module_env: _ConstEnv, fn) -> _ConstEnv:
    env = _ConstEnv()
    env._vals.update(module_env._vals)
    if fn is not None:
        # parameters are caller-supplied, never provably constant (and
        # a later local assignment over the same name stays poisoned)
        for a in list(fn.args.args) + list(fn.args.kwonlyargs) + \
                list(fn.args.posonlyargs):
            env.bind(a.arg, None)
        _collect_env(fn.body, env)
    return env


# ------------------------------------------------- deadline-propagation
@register
class DeadlinePropagation(Rule):
    id = "deadline-propagation"
    summary = ("timeouts in client/, net/, lifecycle/, "
               "replication_geo/ and the codec service must derive "
               "from resilience.Deadline, never from numeric "
               "literals; socket timeouts repo-wide")
    rationale = (
        "The reference's native_dn once hardcoded a 120 s connect "
        "timeout, so a dead peer consumed the whole operation budget "
        "before the first retry. Every hop's timeout must derive from "
        "the ambient resilience.Deadline (op_timeout()/"
        "Deadline.timeout()) or an EWMA/env-derived knob.")

    SLEEPS = {"sleep"}
    TIMEOUT_KWARGS = {"timeout", "timeout_s", "deadline_s"}
    POSITIONAL_WAITS = {"wait", "join", "result", "wait_for"}

    def check(self, src: SourceFile) -> Iterable[Finding]:
        if src.is_module("client", "resilience.py"):
            return  # the implementation of the discipline itself
        in_scope = (src.in_dirs("client", "net", "lifecycle",
                                "replication_geo")
                    or src.is_module("codec", "service.py")
                    # the sharded metadata plane retries through ring
                    # failovers — its waits must be deadline-derived
                    or src.module_parts[:2] == ("om", "sharding"))
        module_env = _ConstEnv()
        _collect_env(src.tree.body, module_env, recurse=False)
        # per-function env memo, scoped to THIS check pass: fn nodes
        # stay alive via src.tree, so id() keys cannot be recycled
        # (a process-global id-keyed cache could alias freed nodes)
        envs: dict[int, _ConstEnv] = {}
        for call, fn in src.calls_with_fn:
            name = last_name(call.func)
            # the constant environment is built only for the calls that
            # can need it (most calls of most files cannot)
            if name not in ("create_connection", "settimeout") and not (
                    in_scope and (
                        name in self.POSITIONAL_WAITS or name == "sleep"
                        or any(k.arg in self.TIMEOUT_KWARGS
                               for k in call.keywords))):
                continue
            key = id(fn)
            env = envs.get(key)
            if env is None:
                env = envs[key] = _fn_env(module_env, fn)
            dot = dotted(call.func)

            # socket timeouts: repo-wide (the 120 s connect class)
            if name == "create_connection":
                for kw in call.keywords:
                    if kw.arg == "timeout" and \
                            _fold(kw.value, env) is not None:
                        yield self._f(src, kw.value,
                                      "socket connect timeout is a "
                                      "numeric literal")
                if len(call.args) >= 2 and \
                        _fold(call.args[1], env) is not None:
                    yield self._f(src, call.args[1],
                                  "socket connect timeout is a "
                                  "numeric literal")
                continue
            if name == "settimeout" and call.args and \
                    _fold(call.args[0], env) is not None:
                yield self._f(src, call.args[0],
                              "socket timeout is a numeric literal")
                continue

            if not in_scope:
                continue

            # bare sleeps: backoff belongs to resilience.RetryPolicy
            if dot in ("time.sleep", "_time.sleep"):
                yield self._f(
                    src, call, "bare time.sleep on a deadline-scoped "
                    "path — retries/backoff must ride "
                    "resilience.RetryPolicy", what="call")
                continue

            # literal timeout keyword on any call
            for kw in call.keywords:
                if kw.arg in self.TIMEOUT_KWARGS and \
                        _fold(kw.value, env) is not None:
                    yield self._f(src, kw.value,
                                  f"literal `{kw.arg}=` on `{dot or name}()`")
            # literal positional timeout on the known blocking verbs
            if name in self.POSITIONAL_WAITS and len(call.args) == 1 \
                    and _fold(call.args[0], env) is not None:
                yield self._f(src, call.args[0],
                              f"literal timeout passed to `.{name}()`")

    def _f(self, src: SourceFile, node: ast.AST, what_msg: str,
           what: str = "timeout") -> Finding:
        msg = what_msg if what == "call" else (
            f"{what_msg} — derive it from resilience.op_timeout()/"
            f"Deadline.timeout() or a documented env knob")
        return Finding(self.id, src.display_path, node.lineno, msg,
                       span=_span(node))


# ------------------------------------------------- blocking-under-lock
@register
class BlockingUnderLock(Rule):
    id = "blocking-under-lock"
    summary = ("no blocking call (sleep, future/thread join, queue get, "
               "socket or device I/O) lexically inside a held lock")
    rationale = (
        "The codec-service dispatcher packs under its lock but "
        "launches on the card OUTSIDE it; holding any lock across a "
        "blocking call is the lock-convoy/deadlock shape that "
        "thread-sanitizer gates catch in mature storage systems. "
        "Condition.wait() is exempt — it releases the lock.")

    SOCKET_OPS = {"recv", "recv_into", "sendall", "accept", "connect",
                  "create_connection"}
    DEVICE_OPS = {"block_until_ready", "device_put", "wait_result",
                  "drain"}
    SUBPROC_OPS = {"communicate", "check_output", "check_call"}

    def check(self, src: SourceFile) -> Iterable[Finding]:
        if src.in_dirs("testing", "tools"):
            return
        findings: list[Finding] = []

        def lockish(expr: ast.AST) -> Optional[str]:
            n = last_name(expr).lower()
            if isinstance(expr, ast.Call):
                n = last_name(expr.func).lower()
            if any(t in n for t in ("lock", "mutex", "cond")) or \
                    n in ("cv", "_cv"):
                return n
            return None

        def condish(name: str) -> bool:
            n = name.lower()
            return "cond" in n or n in ("cv", "_cv")

        def classify(call: ast.Call) -> Optional[str]:
            name = last_name(call.func)
            dot = dotted(call.func)
            recv = receiver_name(call.func)
            if dot in ("time.sleep", "_time.sleep"):
                return "time.sleep"
            if name in self.SOCKET_OPS and recv not in ("self",):
                return f"socket .{name}()"
            if name in self.DEVICE_OPS or "dispatch" in name.lower():
                return f"device/pipeline `{name}()`"
            if dot.startswith("subprocess.") and name in (
                    self.SUBPROC_OPS | {"run", "call"}):
                return f"subprocess.{name}()"
            if name in self.SUBPROC_OPS:
                return f".{name}()"
            if name == "result":
                return "future .result()"
            if name == "join" and _join_is_thread_join(call):
                return "thread .join()"
            if name in ("wait", "wait_for") and not condish(recv):
                return f"non-condition .{name}()"
            if name == "get" and not call.args and (
                    not call.keywords or all(
                        k.arg in ("block", "timeout")
                        for k in call.keywords)):
                return "queue .get()"
            return None

        def _join_is_thread_join(call: ast.Call) -> bool:
            """Distinguish Thread.join([timeout]) from str.join(iter):
            zero args, a timeout kwarg, or a single numeric arg."""
            if any(k.arg == "timeout" for k in call.keywords):
                return True
            if not call.args and not call.keywords:
                return True
            return (len(call.args) == 1
                    and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, (int, float)))

        def scan_expr(node: ast.AST, held: list[str]) -> None:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    kind = classify(sub)
                    if kind:
                        findings.append(Finding(
                            self.id, src.display_path, sub.lineno,
                            f"blocking {kind} while holding "
                            f"`{held[-1]}` — move the blocking work "
                            f"outside the lock or use a Condition",
                            span=_span(sub)))

        def scan_body(body: list[ast.stmt], held: list[str]) -> None:
            # NB: mutates the caller's `held` in place so a release()
            # inside a nested block (the acquire/try/finally:release
            # idiom) unwinds the lock for the statements that follow;
            # `with` blocks pass a fresh list since their lock scope
            # ends with the block
            for stmt in body:
                # acquire()/release() bracketing in this statement list
                if isinstance(stmt, ast.Expr) and isinstance(
                        stmt.value, ast.Call):
                    nm = last_name(stmt.value.func)
                    tgt = dotted(stmt.value.func)
                    recv = (stmt.value.func.value
                            if isinstance(stmt.value.func, ast.Attribute)
                            else stmt.value.func)
                    if nm == "acquire" and lockish(recv) is not None:
                        held.append(tgt.rsplit(".", 1)[0] or "lock")
                        continue
                    # only a LOCK-like receiver's release() unwinds —
                    # a buffer/semaphore release inside the region must
                    # not hide blocking calls that follow it
                    if nm == "release" and held and \
                            lockish(recv) is not None:
                        held.pop()
                        continue
                if isinstance(stmt, ast.With):
                    locks = [lockish(item.context_expr)
                             for item in stmt.items]
                    new_held = list(held) + [n for n in locks if n]
                    if held:
                        for item in stmt.items:
                            scan_expr(item.context_expr, held)
                    scan_body(stmt.body, new_held)
                    continue
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    # nested def: body runs later, not under this lock
                    scan_body(stmt.body, [])
                    continue
                if isinstance(stmt, ast.ClassDef):
                    scan_body(stmt.body, [])
                    continue
                if held:
                    # flag blocking calls in this statement's own
                    # expressions, then recurse into compound bodies
                    for field_name, value in ast.iter_fields(stmt):
                        if field_name in ("body", "orelse", "finalbody",
                                          "handlers"):
                            continue
                        if isinstance(value, ast.AST):
                            scan_expr(value, held)
                        elif isinstance(value, list):
                            for v in value:
                                if isinstance(v, ast.AST):
                                    scan_expr(v, held)
                for field_name in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field_name, None)
                    if sub:
                        scan_body(sub, held)
                for h in getattr(stmt, "handlers", []) or []:
                    scan_body(h.body, held)

        scan_body(src.tree.body, [])
        yield from findings


# ----------------------------------------------- fence-carrying-commit
@register
class FenceCarryingCommit(Rule):
    id = "fence-carrying-commit"
    summary = ("ring requests that mutate term-fenced state must pass "
               "their fencing term / expected object id")
    rationale = (
        "The duplicate-allocation and lifecycle lessons: an unfenced "
        "mutation from a deposed leader or a background job racing a "
        "user overwrite silently loses data. LifecycleCheckpoint and "
        "GeoCheckpoint must carry `term`; "
        "CommitKey/CommitFile/DeleteKey must carry "
        "`expect_object_id` (\"\" only where unfenced semantics are the "
        "documented API, with an ozlint suppression saying why); the "
        "cross-shard 2PC verbs (ShardPrepare/ShardCommit/ShardAbort) "
        "must carry the coordinator's shard-map `epoch`.")

    #: constructor -> (required kwarg, positional index or None)
    FENCED = {
        "LifecycleCheckpoint": ("term", 0),
        "GeoCheckpoint": ("term", 0),
        "CommitKey": ("expect_object_id", None),
        "CommitFile": ("expect_object_id", None),
        "DeleteKey": ("expect_object_id", None),
        # cross-shard 2PC verbs: every phase record must carry the
        # coordinator's shard-map epoch (prepare fences on it; commit/
        # abort record it for the audit trail)
        "ShardPrepare": ("epoch", 3),
        "ShardCommit": ("epoch", 1),
        "ShardAbort": ("epoch", 1),
    }

    def check(self, src: SourceFile) -> Iterable[Finding]:
        if src.is_module("om", "requests.py") or \
                src.is_module("om", "fso.py") or \
                src.in_dirs("testing", "tools"):
            return
        for call, _fn in src.calls_with_fn:
            name = last_name(call.func)
            spec = self.FENCED.get(name)
            if spec is None:
                continue
            field_name, pos = spec
            has_kw = any(k.arg == field_name for k in call.keywords)
            has_pos = pos is not None and len(call.args) > pos
            if not (has_kw or has_pos):
                yield Finding(
                    self.id, src.display_path, call.lineno,
                    f"`{name}(...)` mutates term-fenced state but does "
                    f"not pass `{field_name}` — an unfenced commit can "
                    f"race a concurrent overwrite or a deposed leader",
                    span=_span(call))


# ------------------------------------------- dispatch-shape-stability
@register
class DispatchShapeStability(Rule):
    id = "dispatch-shape-stability"
    summary = ("lru_cache'd launch plans must not be keyed on per-call "
               "widths, and a plan keyed on an erasure pattern needs a "
               "finite cache bound")
    rationale = (
        "The reference made the recovery matrix a traced argument after "
        "per-erasure-pattern closures thrashed the jit cache, and its "
        "bench bimodality was first-touch plan compiles in the timed "
        "region. The port launches one compiled kernel with the plan as "
        "an argument, so the risk moves to the plan caches "
        "(codec/fused.py, fused_kernel.py, torch_coder.py, crc_device.py, "
        "lrc_math.py): a cache keyed on a batch width misses on every new "
        "request shape and pays a host-to-device copy in the timed path, "
        "and an unbounded cache keyed on an erasure pattern grows with "
        "every pattern a failing cluster shows it.")

    #: per-call sizes: never a plan-cache key
    WIDTHS = {"batch", "width", "batch_width", "n_stripes", "stripes"}
    #: erasure patterns: a bounded space, cached behind a finite maxsize
    PATTERNS = {"erased", "valid", "pattern", "erasure", "erasure_pattern",
                "lost", "survivors", "recovery"}

    def check(self, src: SourceFile) -> Iterable[Finding]:
        for fn in src.functions:
            bound = self._cache_bound(fn)
            if bound is False:
                continue
            params = [a.arg for a in fn.args.posonlyargs + fn.args.args
                      + fn.args.kwonlyargs]
            widths = [p for p in params if p in self.WIDTHS]
            if widths:
                yield Finding(
                    self.id, src.display_path, fn.lineno,
                    f"lru_cache'd launch plan keyed on per-call width "
                    f"{', '.join(widths)} — every new request shape "
                    f"misses and rebuilds the plan; key it on the coder "
                    f"options and pass the width at launch",
                    span=(fn.lineno, fn.lineno))
            patterns = [p for p in params if p in self.PATTERNS]
            if patterns and bound is None:
                yield Finding(
                    self.id, src.display_path, fn.lineno,
                    f"unbounded cache keyed on erasure pattern "
                    f"{', '.join(patterns)} — give the lru_cache a "
                    f"finite maxsize",
                    span=(fn.lineno, fn.lineno))

    @staticmethod
    def _cache_bound(fn):
        """False when `fn` is not cached; None when its cache is unbounded
        (`@cache`, `@lru_cache(maxsize=None)`); else True."""
        for dec in fn.decorator_list:
            name = last_name(dec.func) if isinstance(dec, ast.Call) \
                else last_name(dec)
            if name == "cache":
                return None
            if name != "lru_cache":
                continue
            if not isinstance(dec, ast.Call):
                return True  # @lru_cache: maxsize 128
            size = dec.args[0] if dec.args else next(
                (k.value for k in dec.keywords if k.arg == "maxsize"), None)
            if isinstance(size, ast.Constant) and size.value is None:
                return None
            return True
        return False


# ---------------------------------------------------- datapath-no-copy
@register
class DatapathNoCopy(Rule):
    id = "datapath-no-copy"
    summary = ("the wire-facing datapath modules must not materialize "
               "payload bytes: no `bytes(...)`, `.tobytes()`, or "
               "`.copy()` of a fresh buffer view")
    rationale = (
        "The zero-copy datapath contract: payloads travel as "
        "memoryviews/ndarray views over pooled buffers "
        "(codec/hostmem.py) from socket to card. One stray "
        "`bytes(frame)` on a 4 MiB chunk silently doubles the memory "
        "traffic of every request that crosses it — exactly the class "
        "of regression the copies/moved registry exists to catch. "
        "Control-plane materializations (STATUS/JSON headers, the one "
        "copy a transport's type contract forces) carry a reasoned "
        "`# ozlint: allow[datapath-no-copy] -- why`.")

    #: the wire-facing modules under the zero-copy contract
    MODULES = {
        ("client", "native_dn.py"),
        ("client", "ec_writer.py"),
        ("client", "ec_reader.py"),
        ("net", "dn_service.py"),
    }
    #: `.copy()` on the RESULT of one of these producers is a fresh
    #: view being materialized (np.frombuffer(...).copy() & friends)
    VIEW_PRODUCERS = {"frombuffer", "payload_array", "asarray",
                      "ascontiguousarray", "as_array"}

    def check(self, src: SourceFile) -> Iterable[Finding]:
        if tuple(src.module_parts) not in self.MODULES:
            return
        for call, _fn in src.calls_with_fn:
            name = last_name(call.func)
            if isinstance(call.func, ast.Name) and name == "bytes":
                # bytes(8) preallocates, bytes() is empty — neither
                # copies a payload; bytes(buf) does
                if len(call.args) == 1 and not call.keywords and not (
                        isinstance(call.args[0], ast.Constant)
                        and isinstance(call.args[0].value, int)):
                    yield Finding(
                        self.id, src.display_path, call.lineno,
                        "`bytes(...)` materializes a payload copy — "
                        "keep the memoryview/ndarray view (pooled "
                        "lease), or suppress with a reason if this is "
                        "control-plane framing",
                        span=_span(call))
            elif name == "tobytes" and isinstance(call.func,
                                                  ast.Attribute):
                yield Finding(
                    self.id, src.display_path, call.lineno,
                    "`.tobytes()` copies the array — pass the array "
                    "itself (wire.pack and the socket layer take "
                    "buffer views)",
                    span=_span(call))
            elif name == "copy" and isinstance(call.func, ast.Attribute) \
                    and isinstance(call.func.value, ast.Call) and \
                    last_name(call.func.value.func) in self.VIEW_PRODUCERS:
                yield Finding(
                    self.id, src.display_path, call.lineno,
                    f"`{last_name(call.func.value.func)}(...).copy()` "
                    f"defeats the zero-copy view it just made — return "
                    f"the view; consumers that need ownership copy at "
                    f"their edge (counted)",
                    span=_span(call))


# ---------------------------------------------------- error-swallowing
@register
class ErrorSwallowing(Rule):
    id = "error-swallowing"
    summary = ("no bare `except:` and no `except ...: pass` on "
               "datapath/consensus modules")
    rationale = (
        "A swallowed exception on the datapath converts a loud failure "
        "into silent data loss or a wedged control loop (the class of "
        "bug soak post-mortems dig out of replay paths). "
        "Handle it, log it, or suppress with a written reason.")

    DIRS = ("client", "codec", "net", "storage", "consensus", "scm",
            "om", "lifecycle", "parallel", "replication_geo")

    def check(self, src: SourceFile) -> Iterable[Finding]:
        if not src.in_dirs(*self.DIRS):
            return
        for node in src.nodes:
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield Finding(
                    self.id, src.display_path, node.lineno,
                    "bare `except:` catches SystemExit/KeyboardInterrupt "
                    "and hides the real error — name the exception",
                    span=(node.lineno, node.lineno))
                continue
            if all(isinstance(s, (ast.Pass, ast.Continue)) or
                   (isinstance(s, ast.Expr) and isinstance(
                       s.value, ast.Constant)) for s in node.body):
                yield Finding(
                    self.id, src.display_path, node.lineno,
                    "exception swallowed without handling or logging — "
                    "a datapath error must be handled, logged, or "
                    "suppressed with a reason",
                    span=(node.lineno, node.lineno))


# ------------------------------------------------------- bounded-queue
@register
class BoundedQueue(Rule):
    id = "bounded-queue"
    summary = ("server-side packages (net/, om/, scm/, gateway/, "
               "codec/) must not construct unbounded queue.Queue / "
               "deque instances")
    rationale = (
        "The overload-protection contract (admission/): every "
        "queue a service hop feeds must have an explicit bound, because "
        "an unbounded queue accepts work faster than it drains and "
        "converts overload into memory growth + unbounded latency — the "
        "collapse mode admission control exists to prevent. DAGOR-style "
        "shedding only works if there is nowhere for excess work to "
        "hide. A queue whose depth is provably bounded by other "
        "machinery (an ack window, an admission gate upstream) carries "
        "a reasoned `# ozlint: allow[bounded-queue] -- why`.")

    DIRS = ("net", "om", "scm", "gateway", "codec")
    #: client-side modules that batch work for server hops — the slab
    #: packer's pending set is a server-feeding queue in client clothing
    MODULES = (("client", "slab.py"),)
    #: queue-class constructors taking maxsize as kwarg or first arg
    QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue"}

    def check(self, src: SourceFile) -> Iterable[Finding]:
        if not src.in_dirs(*self.DIRS) and not any(
                src.is_module(*m) for m in self.MODULES):
            return
        module_env = _ConstEnv()
        _collect_env(src.tree.body, module_env, recurse=False)
        envs: dict[int, _ConstEnv] = {}
        for call, fn in src.calls_with_fn:
            name = last_name(call.func)
            if name not in self.QUEUE_CTORS and name not in (
                    "SimpleQueue", "deque"):
                continue
            key = id(fn)
            env = envs.get(key)
            if env is None:
                env = envs[key] = _fn_env(module_env, fn)
            if name == "SimpleQueue":
                yield Finding(
                    self.id, src.display_path, call.lineno,
                    "`SimpleQueue()` cannot be bounded — use "
                    "`queue.Queue(maxsize=...)` so excess work is "
                    "refused, not accumulated",
                    span=_span(call))
            elif name in self.QUEUE_CTORS:
                bound = None
                if call.args:
                    bound = call.args[0]
                for kw in call.keywords:
                    if kw.arg == "maxsize":
                        bound = kw.value
                if bound is None:
                    yield self._unbounded(src, call, name,
                                          "no `maxsize`")
                else:
                    v = _fold(bound, env)
                    if v is not None and v <= 0:
                        yield self._unbounded(
                            src, call, name,
                            f"`maxsize={int(v)}` (non-positive = "
                            f"unlimited)")
            else:  # deque
                bound = call.args[1] if len(call.args) >= 2 else None
                for kw in call.keywords:
                    if kw.arg == "maxlen":
                        bound = kw.value
                if bound is None or (
                        isinstance(bound, ast.Constant)
                        and bound.value is None):
                    yield self._unbounded(src, call, "deque",
                                          "no `maxlen`")

    def _unbounded(self, src: SourceFile, call: ast.Call, ctor: str,
                   why: str) -> Finding:
        return Finding(
            self.id, src.display_path, call.lineno,
            f"unbounded `{ctor}(...)` on a server-side module ({why}) "
            f"— give it an explicit bound so overload is refused at "
            f"admission instead of accumulating, or suppress with the "
            f"reason the depth is bounded elsewhere",
            span=_span(call))


@register
class SpanOnDispatch(Rule):
    id = "span-on-dispatch"
    summary = ("codec device edges run inside an active trace span; RPC "
               "handlers register only through RpcServer.add_service")
    rationale = (
        "The latency-attribution contract: every device edge (the "
        "kernel launch, the pinned device-to-host copy, the CUDA event "
        "record and synchronize, and the start_pull / finish_pull "
        "helpers around them) must be bracketed by a span, or fabricate "
        "one with record_span, or carry one with activate, or the "
        "slow-request flight recorder gives that time to the parent and "
        "the critical path lies. Likewise a handler put into an "
        "RpcServer's method table outside net/rpc.py skips the worker "
        "that opens the server span and reads the wire trace context.")

    #: calls that hand work to (or synchronize with) the device
    EDGE_CALLS = {"start_pull", "finish_pull"}
    #: the ctypes library's kernel entry: `lib.fused_encode_crc(...)`
    KERNEL_ENTRIES = {"fused_encode_crc"}
    #: CUDA event methods
    EVENT_OPS = {"record", "synchronize"}
    #: any of these inside the same function satisfies the invariant
    TRACE_CALLS = {"span", "record_span", "activate"}

    def _edge(self, call: ast.Call) -> bool:
        name = last_name(call.func)
        recv = receiver_name(call.func)
        if name in self.EDGE_CALLS:
            return True
        if name in self.KERNEL_ENTRIES and recv == "lib":
            return True
        if name in self.EVENT_OPS and recv not in ("", "self") \
                and not call.args:
            return True
        return name == "copy_" and any(
            k.arg == "non_blocking" and not (
                isinstance(k.value, ast.Constant) and not k.value.value)
            for k in call.keywords)

    def check(self, src: SourceFile) -> Iterable[Finding]:
        # (b) a handler put into an RpcServer's method table anywhere but
        # net/rpc.py dodges the worker that opens the server span
        if not src.is_module("net", "rpc.py"):
            for node in src.nodes:
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        if isinstance(t, ast.Subscript) and \
                                last_name(t.value) == "_methods":
                            yield Finding(
                                self.id, src.display_path, node.lineno,
                                "RPC handler put into a method table "
                                "outside net/rpc.py bypasses the span "
                                "guard (no server span, no trace-context "
                                "extraction) — register through "
                                "RpcServer.add_service",
                                span=_span(node))
        # (a) codec functions containing a device edge must trace
        if not src.in_dirs("codec"):
            return
        edges_by_fn: dict[int, list[ast.Call]] = {}
        traced_fns: set[int] = set()
        fns: dict[int, ast.AST] = {}
        for call, fn in src.calls_with_fn:
            if fn is None:
                continue
            if self._edge(call):
                fns[id(fn)] = fn
                edges_by_fn.setdefault(id(fn), []).append(call)
            elif last_name(call.func) in self.TRACE_CALLS:
                traced_fns.add(id(fn))
        for key, edges in edges_by_fn.items():
            if key in traced_fns:
                continue
            first = min(edges, key=lambda c: c.lineno)
            fn_name = getattr(fns[key], "name", "<fn>")
            yield Finding(
                self.id, src.display_path, first.lineno,
                f"device dispatch in `{fn_name}` without an active "
                "span — wrap it in Tracer.span()/record_span() (or "
                "activate() a carried context) so the flight "
                "recorder's critical path can name this stage",
                span=(first.lineno, first.lineno))
