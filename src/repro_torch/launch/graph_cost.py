"""Trace a per-rank program with fake tensors, and read its cost and memory
from the one graph (the port's `launch/hlo_cost.py` and
`launch/hlo_analysis.py`).

The JAX dry run lowers and compiles each cell on placeholder devices and
reads the HLO. The port traces instead: `trace(fn, args)` runs `fn` on
fake tensors (`torch._subclasses.fake_tensor`: a shape, a dtype and a
device, no storage) twice — once eagerly, to follow every storage from
its allocation to its last reference as the eager program would, and
once under `make_fx`, for the graph of operator calls. Under a fake
process group (`launch.mesh.fake_world`) the collectives are graph nodes
too (`c10d::allreduce_`, `c10d::_allgather_base_`, ...), and the CUDA
kernels are their registered operators (`repro_torch::wnn_ensemble`,
`repro_torch::h3_hash`), never built or launched. Nothing is allocated
on any device.

From that graph and that run (`cost`):

* operations by type: a registered flop formula where the operator has
  one (the integer kernels count their operations as they issue them,
  as int32 work; flash its FLOP at its output's type; a matmul its FLOP,
  float32 ones as multiply-adds), else one operation an
  element of the larger of its outputs and inputs; views and
  uninitialised allocations none;
* the bytes each node reads and writes, each tensor input read once and
  each output written once (gathers read what they gather). Eager
  PyTorch does not fuse, so this is the eager program's own traffic, not
  a bound;
* collectives by kind, with operand, output and ring-model link bytes
  and group size;
* memory: the arguments, the outputs, the outputs that are arguments
  updated in place (alias), and the peak of live storage over the eager
  run with the arguments held throughout; a storage on the card counts
  as the CUDA caching allocator hands it out, rounded up to 512 bytes.

A torch built without CUDA has no CUDA device guard, and indexing a fake
CUDA tensor fails in the guard lookup; `ensure_fake_cuda_guard` then
compiles and loads `csrc/fake_cuda_guard.cpp` (a C++ compiler and
torch's headers; seconds, cached under `build/torch_ext/`), the no-op
guard FakeTensorMode means to install. Its autograd engine still needs a
card's streams, so on such a build a training step is traced as the CPU
program (`launch.uleen_cell.autograd_traceable`).

Host round trips are findings, never crashes: a read of a device value
on the host (`int()`, `float()`, `bool()`, `.item()`, `.tolist()`,
`.numpy()` of a tensor, `aten::_local_scalar_dense`) is recorded with
the port's file and line and answered with 0 so the trace goes on; an
operator whose output shape depends on the data stops the trace and is
recorded the same way.

The roofline's rates are datasheet figures for an NVIDIA H100 SXM (H100
80GB HBM3, 700 W), not measurements: 3.35 TB/s of HBM; 33.5 T
operations/s on float32 lanes and 16.75 T/s on int32 lanes (one an SM
lane a clock), 989 TFLOP/s dense bf16 on the tensor cores; for
collectives 450 GB/s a direction between the 8 cards of a node (NVLink)
and 50 GB/s a card between nodes (400 Gb/s). The collective rate is a
model that one card cannot check.
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
import hashlib
import os
import subprocess
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"float32": 33.5e12, "int32": 16.75e12, "bf16": 989e12}
NVLINK_BYTES_PER_S = 450e9       # a direction, within a node
NIC_BYTES_PER_S = 50e9           # a card, across nodes
RANKS_PER_NODE = 8
CUDA_ALLOC_BYTES = 512           # the caching allocator's rounding

# c10d operator -> collective kind (the HLO names the JAX rules use)
COLLECTIVE_KINDS = {
    "c10d::_allgather_base_": "all-gather", "c10d::allgather_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all", "c10d::alltoall_base_": "all-to-all",
    "c10d::broadcast_": "broadcast", "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
    # the functional collectives DTensor and `dist.placed` emit (their
    # `wait_tensor` is bookkeeping: no collective, no bytes)
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    # DTensor's redistribution of a shard from one tensor dim to another
    # on the same mesh dim (query rows from a column shard)
    "_dtensor::shard_dim_alltoall": "all-to-all",
}
# collectives whose (input, ..., group name) give the operand and group
_FUNCTIONAL = ("_c10d_functional::", "_dtensor::shard_dim_alltoall")
# operators that read only what they gather
_GATHERS = {"aten::index", "aten::gather", "aten::index_select",
            "aten::embedding", "aten::take"}
# allocations that touch no memory
_NO_TOUCH = {"aten::empty", "aten::empty_strided", "aten::empty_like",
             "aten::new_empty", "aten::new_empty_strided", "aten::lift_fresh",
             "aten::lift_fresh_copy", "_c10d_functional::wait_tensor"}
_HOST_METHODS = ("__int__", "__float__", "__bool__", "__index__", "item",
                 "tolist", "numpy")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(os.path.dirname(_PKG))


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

_GUARD: list = []


def ensure_fake_cuda_guard() -> None:
    """Make fake CUDA tensors indexable in a torch built without CUDA (see
    the module docstring); nothing to do in a CUDA build."""
    if torch.backends.cuda.is_built() or _GUARD:
        return
    from repro_torch.kernels import build
    src = Path(__file__).resolve().parent / "csrc" / "fake_cuda_guard.cpp"
    tdir = Path(torch.__file__).resolve().parent
    flags = ["-O1", "-std=c++17", "-shared", "-fPIC",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             f"-I{tdir / 'include'}", f"-L{tdir / 'lib'}", "-lc10",
             f"-Wl,-rpath,{tdir / 'lib'}"]
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        flags + [torch.__version__]).encode()).hexdigest()[:16]
    out = build.BUILD_DIR / f"libfake_cuda_guard-{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cc = os.environ.get("CXX", "c++")
        proc = subprocess.run([cc, str(src), *flags, "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(
                "tracing the card's program with a torch built without CUDA "
                f"needs {cc} for its no-op CUDA device guard:\n"
                f"{proc.stdout}{proc.stderr}\n(or trace the CPU program: "
                "device='cpu')")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    if not lib.fake_cuda_guard_registered():
        raise RuntimeError("the no-op CUDA device guard did not register")
    _GUARD.append(lib)

@dataclasses.dataclass(frozen=True)
class HostRead:
    """One host round trip in a traced program."""
    op: str          # the method or operator
    where: str       # "src/repro_torch/...py:LINE" of the port's call
    kind: str = "host_read"      # | "data_dependent_shape"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Traced:
    """One traced per-rank program."""
    graph: Optional[torch.fx.GraphModule]
    device: torch.device
    memory: dict          # bytes: args, output, temp, alias, peak
    host_reads: list      # [HostRead]
    error: Optional[str] = None

    def op_counts(self) -> dict:
        """{operator name: nodes} over the whole graph."""
        from repro_torch.analysis import graph_walk
        out: dict = {}
        for node in graph_walk.all_nodes(self.graph) if self.graph else ():
            name = graph_walk.op_name(node)
            if name:
                out[name] = out.get(name, 0) + 1
        return out


class _Abort(Exception):
    """Raised to stop a trace at a host round trip it cannot answer."""


def _where() -> str:
    """The innermost frame of the port outside this module, as a path
    from the repository root and a line."""
    here = os.path.abspath(__file__)
    fallback = ""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path == here:
            continue
        if path.startswith(_PKG + os.sep):
            return f"{os.path.relpath(path, _REPO)}:{frame.lineno}"
        if not fallback and f"{os.sep}torch{os.sep}" not in path:
            fallback = f"{path}:{frame.lineno}"
    return fallback or "unknown"


def _zero_like(t: torch.Tensor):
    if t.dtype == torch.bool:
        return False
    return 0.0 if (t.is_floating_point() or t.is_complex()) else 0


class _HostReads(TorchFunctionMode):
    """Records every read of a tensor's value on the host; answers a
    scalar read with 0 and stops the trace at a whole-array read."""

    def __init__(self, reads: list):
        super().__init__()
        self.reads = reads

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _HOST_METHODS and args and isinstance(args[0],
                                                         torch.Tensor):
            self.reads.append(HostRead(name, _where()))
            if name in ("tolist", "numpy"):
                raise _Abort(f"{name}() of a device tensor")
            return _zero_like(args[0])
        return func(*args, **(kwargs or {}))


def _nbytes(st, granule: int) -> int:
    n = int(st.nbytes())
    return -(-n // granule) * granule if granule > 1 and n else n


class _Memory(TorchDispatchMode):
    """Live storage bytes over an eager run: every operator output's
    storage counts from its allocation until its last reference dies."""

    def __init__(self, granule: int, reads: list):
        super().__init__()
        self.granule = granule
        self.reads = reads
        self.live = 0
        self.peak = 0
        self.refs: dict = {}

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.refs:
            return
        n = _nbytes(st, self.granule)
        self.live += n
        self.peak = max(self.peak, self.live)

        def release(_, key=key, n=n):
            self.live -= n
            self.refs.pop(key, None)
        self.refs[key] = weakref.ref(st, release)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads.append(HostRead("_local_scalar_dense", _where()))
            return _zero_like(args[0])
        out = func(*args, **(kwargs or {}))
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # on the device it returns its input, the collective's buffer:
            # a fake result is a new storage, which holds the input alive
            # and counts nothing of its own
            self.alias(out, args[0])
            return out
        # every output, views too: a view shares a storage that is held
        # already, but an aliasing operator may copy (`aten.to` of a
        # DTensor to another dtype) and then its output is new
        for t in _tensor_leaves(out):
            self.hold(t)
        return out

    def alias(self, out: torch.Tensor, of: torch.Tensor) -> None:
        """`out`'s storage as `of`'s: no bytes of its own, and `of` live
        while `out` is."""
        st = out.untyped_storage()
        key = id(st)
        if key in self.refs:
            return
        out._alias_of = of
        self.refs[key] = weakref.ref(
            st, lambda _, key=key: self.refs.pop(key, None))


def _tensor_leaves(val):
    """The tensors of an operator's value; a DTensor (a placed program's
    operators, as a mode sees them) by this rank's local shard, which is
    what the rank holds."""
    if isinstance(val, torch.Tensor):
        local = getattr(val, "_local_tensor", None)
        yield val if local is None else local
    elif isinstance(val, (list, tuple)):
        for v in val:
            yield from _tensor_leaves(v)


def flatten(obj, path: str = "") -> list:
    """[(path, tensor)] of every tensor in `obj`: through tuples, lists,
    dicts, NamedTuples and dataclass fields (private ones included), in a
    fixed order; any other object is opaque."""
    if isinstance(obj, torch.Tensor):
        return [(path, obj)]
    if isinstance(obj, dict):
        return [x for k, v in obj.items() for x in flatten(v, f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        names = getattr(obj, "_fields", None)
        return [x for i, v in enumerate(obj)
                for x in flatten(v, f"{path}.{names[i]}" if names
                                 else f"{path}[{i}]")]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [x for f in dataclasses.fields(obj)
                for x in flatten(getattr(obj, f.name), f"{path}.{f.name}")]
    return []


def rebuild(obj, tensors):
    """`obj` with its tensors replaced, in `flatten` order, by the items
    of the iterator `tensors` (a dataclass is copied field by field, so a
    derived cache such as `PackedTables.kernel_args` travels along)."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    if isinstance(obj, dict):
        return type(obj)((k, rebuild(v, tensors)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        items = [rebuild(v, tensors) for v in obj]
        if getattr(obj, "_fields", None):
            return type(obj)(*items)
        return type(obj)(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(out, f.name, rebuild(getattr(obj, f.name),
                                                    tensors))
        return out
    return obj


def _storages(tensors) -> dict:
    return {id(t.untyped_storage()): t.untyped_storage() for t in tensors}


def trace(fn, args: tuple, *, fake_mode, device, memory_fn=None) -> Traced:
    """Trace `fn(*args)`, whose tensors are fake tensors of `fake_mode`,
    as the program that runs on `device`: an eager run for memory and
    host reads, then `make_fx` for the graph. `memory_fn` (same
    arguments), where given, runs in the eager pass instead of `fn`: a
    shorter program with `fn`'s memory and host reads (the first of a
    training step's identical microbatches, `launch.dryrun`)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    device = torch.device(device)
    if device.type == "cuda":
        ensure_fake_cuda_guard()
    granule = CUDA_ALLOC_BYTES if device.type == "cuda" else 1
    inputs = flatten(args, "args")
    in_st = _storages(t for _, t in inputs)
    reads: list = []
    mem = _Memory(granule, reads)
    for key, st in in_st.items():   # held throughout, never released
        mem.refs[key] = st
        mem.live += _nbytes(st, granule)
    mem.peak = mem.live
    args_bytes = mem.live
    memory = dict(args=args_bytes, output=0, temp=0, alias=0, peak=0)
    error = None
    try:
        with fake_mode, mem, _HostReads(reads):
            out = (memory_fn or fn)(*args)
        out_st = _storages(t for _, t in flatten(out))
        alias = sum(_nbytes(s, granule) for k, s in out_st.items()
                    if k in in_st)
        output = sum(_nbytes(s, granule) for k, s in out_st.items()
                     if k not in in_st)
        memory.update(output=output, alias=alias, peak=mem.peak,
                      temp=mem.peak - args_bytes - output + alias)
        del out, out_st
    except Exception as e:      # recorded as a finding, never raised
        error = _record_failure(e, reads)
        memory["peak"] = mem.peak
    if error is not None:
        return Traced(None, device, memory, reads, error)

    def flat_fn(*tensors):
        return fn(*rebuild(args, iter(tensors)))

    graph_reads: list = []
    try:
        # the graph is read, never run: its Python code is generated only
        # if something asks for it (tens of seconds for a training cell's
        # graph of ~10^5 nodes)
        from torch.fx._lazy_graph_module import _use_lazy_graph_module
        with fake_mode, _use_lazy_graph_module(True):
            gm = make_fx(_with_host_reads(flat_fn, graph_reads))(
                *[t for _, t in inputs])
    except Exception as e:
        error = _record_failure(e, reads)
        gm = None
    return Traced(gm, device, memory, reads, error)


class _NoGenerators(TorchFunctionMode):
    """Drops `generator=` from random draws while the graph is made: a
    trace draws no values, and a generator is no graph argument to every
    torch's `make_fx` (torch 2.11 refuses one)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kwargs.get("generator") is not None:
            kwargs = {k: v for k, v in kwargs.items() if k != "generator"}
        return func(*args, **kwargs)


def _with_host_reads(fn, reads):
    def wrapped(*a):
        with _HostReads(reads), _NoGenerators():
            return fn(*a)
    return wrapped


def _record_failure(e: Exception, reads: list) -> str:
    """A failed trace as a string; a data-dependent shape or a host read
    that cannot be answered is also recorded as a host round trip."""
    from torch._subclasses import fake_tensor as ft
    if isinstance(e, (ft.DynamicOutputShapeException,
                      ft.DataDependentOutputException)):
        reads.append(HostRead(str(getattr(e, "func", e)), _where_of(e),
                              kind="data_dependent_shape"))
    return f"{type(e).__name__}: {e}"


def _where_of(e: Exception) -> str:
    """The innermost frame of the port in `e`'s traceback."""
    for frame in reversed(traceback.extract_tb(e.__traceback__)):
        path = os.path.abspath(frame.filename)
        if path.startswith(_PKG + os.sep) and \
                path != os.path.abspath(__file__):
            return f"{os.path.relpath(path, _REPO)}:{frame.lineno}"
    return "unknown"


# ---------------------------------------------------------------------------
# Cost
# ---------------------------------------------------------------------------

def _val_bytes(val) -> int:
    return sum(t.numel() * t.element_size() for t in _tensor_leaves(val))


def _arg_tensors(node) -> list:
    out = []
    for a in list(node.args) + list(node.kwargs.values()):
        for x in (a if isinstance(a, (list, tuple)) else [a]):
            if isinstance(x, torch.fx.Node):
                out += list(_tensor_leaves(x.meta.get("val")))
    return out


def node_bytes(node) -> tuple[int, int]:
    """(bytes read, bytes written) of one operator node in the eager
    program: each tensor input read once, each output written once; a
    gather reads its indices and what it gathers; a view, an uninitialised
    allocation or a non-operator node moves nothing."""
    from repro_torch.analysis.graph_walk import op_name
    name = op_name(node)
    if not name or getattr(node.target, "is_view", False) \
            or name in _NO_TOUCH or name.startswith("prim::"):
        return 0, 0
    out_val = node.meta.get("val")
    written = _val_bytes(out_val)
    ins = _arg_tensors(node)
    if name in _GATHERS:
        index = sum(t.numel() * t.element_size() for t in ins
                    if not t.is_floating_point() and t is not ins[0])
        return written + index, written
    if name.startswith(("c10d::", *_FUNCTIONAL)):
        return sum(t.numel() * t.element_size() for t in ins), written
    if name.endswith("_") and ins:          # in place: the result is an input
        written = _val_bytes(ins[0])
    return sum(t.numel() * t.element_size() for t in ins), written


def node_operations(node) -> tuple[str, float]:
    """(type, operations) of one operator node; see the module docstring."""
    from torch.utils.flop_counter import flop_registry
    from repro_torch.analysis.graph_walk import op_name
    name = op_name(node)
    if not name or getattr(node.target, "is_view", False) \
            or name in _NO_TOUCH or name.startswith(("prim::", "c10d::",
                                                     *_FUNCTIONAL)):
        return "int32", 0.0
    out = list(_tensor_leaves(node.meta.get("val")))
    ins = _arg_tensors(node)
    packet = getattr(node.target, "overloadpacket", None)
    if packet in flop_registry:
        args = [a.meta.get("val") if isinstance(a, torch.fx.Node) else a
                for a in node.args]
        kwargs = {k: v.meta.get("val") if isinstance(v, torch.fx.Node)
                  else v for k, v in node.kwargs.items()}
        flops = float(flop_registry[packet](*args, out_val=node.meta.get(
            "val"), **kwargs))
        if name.startswith("repro_torch::") and not (
                out and out[0].is_floating_point()):
            return "int32", flops       # the WNN and hash kernels
        if out and out[0].dtype in (torch.bfloat16, torch.float16):
            return "bf16", flops
        return "float32", flops / 2.0        # multiply-adds on fp32 lanes
    if not out:
        return "int32", 0.0
    n = max(t.numel() for t in out + ins)
    floating = any(t.is_floating_point() for t in out + ins)
    return ("float32" if floating else "int32"), float(n)


@dataclasses.dataclass
class Collective:
    kind: str
    name: str
    operand_bytes: float
    output_bytes: float
    group_size: int
    inter_node: bool
    axis: Optional[str] = None       # the mesh dim whose group it runs on

    @property
    def link_bytes(self) -> float:
        """Ring-model bytes a rank sends (JAX's `CollectiveOp.link_bytes`)."""
        g = max(2, self.group_size)
        if self.kind == "all-reduce":
            return self.operand_bytes * 2 * (g - 1) / g
        if self.kind == "all-gather":
            return self.output_bytes * (g - 1) / g
        if self.kind in ("reduce-scatter", "all-to-all"):
            return self.operand_bytes * (g - 1) / g
        return self.operand_bytes

    @property
    def seconds(self) -> float:
        rate = NIC_BYTES_PER_S if self.inter_node else NVLINK_BYTES_PER_S
        return self.link_bytes / rate


def _group_of(gm, node):
    """The process group a c10d node runs on (None if not found): a
    boxed group argument, or a functional collective's `group_name`."""
    import torch.distributed as dist
    from repro_torch.analysis.graph_walk import op_name
    if op_name(node).startswith(_FUNCTIONAL):
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        name = node.args[-1]
        try:
            return _resolve_process_group(name)
        except (KeyError, RuntimeError, ValueError):
            return None
    for a in node.args:
        if isinstance(a, torch.fx.Node) and a.op == "get_attr":
            obj = getattr(gm, a.target, None)
            try:
                return dist.ProcessGroup.unbox(obj)
            except Exception:       # a ReduceOp, not a group
                continue
    return None


def _axis_of(group, mesh) -> Optional[str]:
    """The name of `mesh`'s dim whose process group is `group`."""
    if group is None or mesh is None:
        return None
    for i, name in enumerate(mesh.mesh_dim_names):
        try:
            if mesh.get_group(i).group_name == group.group_name:
                return name
        except (RuntimeError, AttributeError):
            continue
    return None


def collectives(gm, mesh=None) -> list:
    """Every collective node of the program, in order; with `mesh`, each
    names the mesh dim its group spans."""
    import torch.distributed as dist
    from repro_torch.analysis.graph_walk import op_name
    out = []
    for node in gm.graph.nodes if gm is not None else ():
        kind = COLLECTIVE_KINDS.get(op_name(node))
        if kind is None:
            continue
        ins = _arg_tensors(node)
        if op_name(node).startswith(_FUNCTIONAL):
            # (input, ..., group name): the input is the operand, the
            # node's value the output
            operand = _val_bytes(ins[:1])
            output = _val_bytes(node.meta.get("val"))
        elif kind == "all-gather":
            # (output buffer, input, group, ...): the input is the operand
            operand = _val_bytes(ins[1:2])
            output = _val_bytes(ins[:1])
        else:
            operand = output = _val_bytes(ins)
        group = _group_of(gm, node)
        size, inter = 1, False
        if group is not None:
            try:
                ranks = dist.get_process_group_ranks(group)
            except (KeyError, RuntimeError, ValueError):
                # the world is gone: the size is known, the placement is
                # not; the slower link is assumed
                ranks = range(0, group.size() * RANKS_PER_NODE,
                              RANKS_PER_NODE)
            size = len(ranks)
            inter = len({r // RANKS_PER_NODE for r in ranks}) > 1
        out.append(Collective(kind, node.name, float(operand), float(output),
                              size, inter, _axis_of(group, mesh)))
    return out


def collective_counts(gm) -> dict:
    """kind -> nodes, over the whole program."""
    out: dict = {}
    for c in collectives(gm):
        out[c.kind] = out.get(c.kind, 0) + 1
    return out


@dataclasses.dataclass
class Roofline:
    """JAX's `hlo_cost.Roofline` keys, read from a traced graph; the two
    raw XLA numbers have no counterpart here (None)."""
    flops_per_device: float          # operations of every type, summed
    hbm_bytes_per_device: float      # eager reads + writes
    collective_bytes_per_device: float   # operand bytes
    link_bytes_per_device: float     # ring-model bytes sent
    collectives_by_kind: dict
    xla_flops_raw: Optional[float]
    xla_bytes_raw: Optional[float]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    useful_ratio: float              # MODEL_FLOPS / (operations × chips)
    dominant: str
    ops_by_type: dict
    hbm_bytes_read: float
    hbm_bytes_written: float
    nodes: int

    def summary(self) -> dict:
        return dataclasses.asdict(self)


def roofline(gm, chips: int, model_flops: float, mesh=None) -> Roofline:
    """The three roofline terms of one traced per-rank program; with
    `mesh`, each kind's collectives are also counted by mesh dim
    (`collectives_by_kind[kind]["axes"]`)."""
    from repro_torch.analysis import graph_walk
    ops: dict = {}
    read = written = 0.0
    n_nodes = 0
    for node in graph_walk.all_nodes(gm) if gm is not None else ():
        if node.op != "call_function":
            continue
        n_nodes += 1
        r, w = node_bytes(node)
        read += r
        written += w
        kind, n = node_operations(node)
        if n:
            ops[kind] = ops.get(kind, 0.0) + n
    colls = collectives(gm, mesh)
    by_kind: dict = {}
    for c in colls:
        d = by_kind.setdefault(c.kind, {"count": 0.0, "operand_bytes": 0.0,
                                        "output_bytes": 0.0,
                                        "link_bytes": 0.0, "group_size": 0})
        d["count"] += 1
        d["operand_bytes"] += c.operand_bytes
        d["output_bytes"] += c.output_bytes
        d["link_bytes"] += c.link_bytes
        d["group_size"] = max(d["group_size"], c.group_size)
        if c.axis is not None:
            axes = d.setdefault("axes", {})
            axes[c.axis] = axes.get(c.axis, 0) + 1
    compute_s = sum(n / OPS_PER_S[k] for k, n in ops.items())
    memory_s = (read + written) / HBM_BYTES_PER_S
    collective_s = sum(c.seconds for c in colls)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    total_ops = sum(ops.values())
    return Roofline(
        flops_per_device=total_ops, hbm_bytes_per_device=read + written,
        collective_bytes_per_device=sum(c.operand_bytes for c in colls),
        link_bytes_per_device=sum(c.link_bytes for c in colls),
        collectives_by_kind=by_kind, xla_flops_raw=None, xla_bytes_raw=None,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=model_flops,
        useful_ratio=(model_flops / (total_ops * chips) if total_ops
                      else 0.0),
        dominant=max(terms, key=terms.get), ops_by_type=ops,
        hbm_bytes_read=read, hbm_bytes_written=written, nodes=n_nodes)


def memory_gib(memory: dict) -> dict:
    """JAX's record `memory` keys (GiB) from `Traced.memory` (bytes)."""
    return {f"{k}_gib": memory[k] / 2 ** 30
            for k in ("args", "output", "temp", "alias", "peak")}


def model_flops_for(cfg, shape) -> float:
    """JAX's `hlo_cost.model_flops_for`: 6·N·D (train), 2·N·D (prefill),
    2·N_active·B (decode: one token a sequence), with N the parameters a
    token touches."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch


def wnn_model_ops(spec) -> int:
    """The paper-style WNN operation count of one inference (JAX's
    `model_flops`, `dryrun.py:195-199, 344-349`): per class and filter
    k·(n + 1) hash XORs and lookups, plus the popcount add."""
    return sum(spec.num_filters(sm) * sm.num_hashes
               * (sm.inputs_per_filter + 1) + spec.num_filters(sm)
               for sm in spec.submodels) * spec.num_classes
