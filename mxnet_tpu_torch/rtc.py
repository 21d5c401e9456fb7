"""mx.rtc — runtime-compiled user kernels: CUDA C++ source compiled by
NVRTC at run time and launched on torch tensors.

≙ ``mxnet_tpu/rtc.py`` (and upstream MXNet's ``python/mxnet/rtc.py``).
The JAX package compiles a user's Pallas kernel function
(``PallasModule``) and refuses CUDA source (``CudaModule`` raises); here
it is the other way round.  ``CudaModule(source, options, exports)``
holds the source, compiles it at the first launch (``_nvrtc``: a CUBIN
for ``sm_90a``, cached on disk by content) and ``get_kernel`` returns a
:class:`Kernel` whose ``launch`` runs on PyTorch's current stream::

    mod = rtc.CudaModule(r'''
    extern "C" __global__ void axpy(const float *x, const float *y,
                                    float *o, long long n) {
      long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
      if (i < n) o[i] = 2.0f * x[i] + y[i];
    }''')
    kern = mod.get_kernel("axpy")          # signature read from the source
    out = kern.launch([x, y, x.numel()], grid=(x.numel() // 256 + 1,),
                      block=(256,))        # o is allocated like x

The surface is the JAX module's where it carries over:

- ``get_kernel(name, signature=None, n_outputs=1)``.  ``signature`` is
  upstream MXNet's C form (``"const float *x, float *o, int n"``); when
  omitted, the parameter list of the ``__global__`` declaration in the
  source is parsed.
- ``Kernel.launch(args, grid=, block=, shared_mem=0, out_shape=,
  out_dtype=)`` returns the outputs.  As in Pallas's ref order, the
  outputs are the last ``n_outputs`` pointer parameters: they are
  allocated (``torch.empty``, ``out_shape`` defaulting to the first
  tensor argument's shape, ``out_dtype`` to the parameter's type) and
  passed in their places; ``args`` fills every other parameter in order.
  ``grid`` and ``block`` are CUDA's dimensions (default ``(1,)``).
  ``block_shapes`` is refused: a TPU ``BlockSpec`` has no counterpart,
  a CUDA kernel indexes by ``blockIdx``/``threadIdx`` itself.
- Every argument is checked against the signature: a pointer takes a
  contiguous CUDA tensor on the launch device of the dtype its type
  names, a scalar a Python number of its type (range-checked).
- A kernel templated on one type parameter (``template <typename T>``)
  binds it to ``out_dtype`` and launches the instantiation
  ``name<ctype>``; ``exports`` names such instantiations (and any other
  kernel that is not ``extern "C"``) so that one program holds them.  A
  name with explicit template arguments (``get_kernel("k<int>")``) is
  that instantiation.

The compiled function is cached per (name expression, device): a
relaunch, also from another thread, compiles nothing.  ``compiles``
counts the NVRTC programs a module built.  An NVRTC error raises
:class:`_nvrtc.NvrtcError` with the program log.  A CPU tensor raises:
the source is CUDA, and the JAX package's CPU route (Pallas interpret
mode) has no counterpart.  ``Kernel.launches`` counts every launch.
"""
from __future__ import annotations

import ctypes
import re
import threading
from typing import List, NamedTuple, Optional, Sequence

import torch

from . import _nvrtc

__all__ = ["CudaModule", "Kernel", "PallasModule", "Param",
           "parse_signature"]

_count_mu = threading.Lock()

# C type (qualifiers and spaces normalised) -> (torch dtype, ctypes scalar)
_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "int": (torch.int32, ctypes.c_int),
    "signed int": (torch.int32, ctypes.c_int),
    "int32_t": (torch.int32, ctypes.c_int),
    "unsigned": (torch.uint32, ctypes.c_uint),
    "unsigned int": (torch.uint32, ctypes.c_uint),
    "uint32_t": (torch.uint32, ctypes.c_uint),
    "long": (torch.int64, ctypes.c_longlong),
    "long int": (torch.int64, ctypes.c_longlong),
    "long long": (torch.int64, ctypes.c_longlong),
    "long long int": (torch.int64, ctypes.c_longlong),
    "int64_t": (torch.int64, ctypes.c_longlong),
    "unsigned long": (torch.uint64, ctypes.c_ulonglong),
    "unsigned long long": (torch.uint64, ctypes.c_ulonglong),
    "uint64_t": (torch.uint64, ctypes.c_ulonglong),
    "size_t": (torch.uint64, ctypes.c_ulonglong),
    "short": (torch.int16, ctypes.c_short),
    "int16_t": (torch.int16, ctypes.c_short),
    "unsigned short": (torch.uint16, ctypes.c_ushort),
    "uint16_t": (torch.uint16, ctypes.c_ushort),
    "char": (torch.int8, ctypes.c_byte),
    "signed char": (torch.int8, ctypes.c_byte),
    "int8_t": (torch.int8, ctypes.c_byte),
    "unsigned char": (torch.uint8, ctypes.c_ubyte),
    "uint8_t": (torch.uint8, ctypes.c_ubyte),
    "bool": (torch.bool, ctypes.c_bool),
    "half": (torch.float16, None),
    "__half": (torch.float16, None),
    "__nv_bfloat16": (torch.bfloat16, None),
    "nv_bfloat16": (torch.bfloat16, None),
    "void": (None, None),
}
# the C type a template parameter is instantiated with for a dtype
_CTYPE_OF = {torch.float32: "float", torch.float64: "double",
             torch.int32: "int", torch.int64: "long long",
             torch.int16: "short", torch.int8: "signed char",
             torch.uint8: "unsigned char", torch.bool: "bool",
             torch.float16: "__half", torch.bfloat16: "__nv_bfloat16",
             torch.uint32: "unsigned int",
             torch.uint64: "unsigned long long"}
_QUALIFIERS = {"const", "volatile", "__restrict__", "__restrict",
               "restrict", "struct"}


class Param(NamedTuple):
    """One kernel parameter: its name, C type (a key of the type table,
    or a template parameter's name), whether it is a pointer and whether
    it points to const."""
    name: str
    ctype: str
    pointer: bool
    const: bool


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", " ", src, flags=re.S)


def parse_signature(signature: str, templates: Sequence[str] = ()
                    ) -> List[Param]:
    """Parse a C parameter list (``"const float *x, float *o, int n"``).
    Types are those of the type table or one of ``templates``; a
    parameter may omit its name.  Raises ``ValueError`` on anything
    else (references, arrays, structs passed by value)."""
    params = []
    sig = _strip_comments(signature).strip()
    if sig in ("", "void"):
        return params
    for i, part in enumerate(sig.split(",")):
        toks = re.findall(r"[A-Za-z_]\w*|\*|&|\[|::", part)
        if any(t in ("&", "[", "::") for t in toks):
            raise ValueError(f"unsupported kernel parameter {part.strip()!r}"
                             ": pass pointers and plain scalars")
        const = "const" in toks
        ptrs = toks.count("*")
        if ptrs > 1:
            raise ValueError(f"unsupported kernel parameter {part.strip()!r}"
                             ": a pointer to a pointer")
        words = [t for t in toks if t not in _QUALIFIERS and t != "*"]
        if not words:
            raise ValueError(f"empty kernel parameter in {signature!r}")

        def known(ws):
            t = " ".join(ws)
            return t if (t in _TYPES or t in templates) else None

        if len(words) > 1 and known(words[:-1]):
            ctype, name = known(words[:-1]), words[-1]
        elif known(words):
            ctype, name = known(words), f"arg{i}"
        else:
            raise ValueError(f"unknown type in kernel parameter "
                             f"{part.strip()!r} (known: {sorted(_TYPES)}"
                             f"{', templates ' + str(list(templates)) if templates else ''})")
        if ctype == "void" and not ptrs:
            raise ValueError(f"kernel parameter {part.strip()!r} is void")
        params.append(Param(name, ctype, bool(ptrs), const))
    return params


def _declaration(source: str, base: str):
    """(template parameter names, parameter list) of ``__global__ void
    base(...)`` in ``source``, or None."""
    lb = r"(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    pat = (r"(?:template\s*<(?P<tp>[^>]*)>\s*)?(?:extern\s*\"C\"\s*)?"
           r"(?:static\s+)?__global__\s+" + lb + r"void\s+" + lb +
           re.escape(base) + r"\s*\((?P<params>[^)]*)\)")
    m = re.search(pat, _strip_comments(source))
    if m is None:
        return None
    tps = []
    for t in (m.group("tp") or "").split(","):
        w = t.split()
        if len(w) == 2 and w[0] in ("typename", "class"):
            tps.append(w[1])
        elif w:
            raise ValueError(f"kernel {base!r}: template parameter {t!r} "
                             "is not a type parameter")
    return tps, m.group("params")


def _split_name(name: str):
    """``"k<int, float>"`` -> ("k", ["int", "float"]); ``"k"`` -> ("k", None)."""
    m = re.fullmatch(r"\s*([A-Za-z_]\w*)\s*(?:<(.*)>)?\s*", name)
    if m is None:
        raise ValueError(f"not a kernel name: {name!r}")
    targs = None if m.group(2) is None else \
        [" ".join(a.split()) for a in m.group(2).split(",")]
    return m.group(1), targs


def _dims(d, what):
    d = (1,) if d is None else ((d,) if isinstance(d, int) else tuple(d))
    if not 1 <= len(d) <= 3 or any(not isinstance(v, int) or v < 1
                                   for v in d):
        raise ValueError(f"{what} must be 1-3 positive ints, got {d!r}")
    return d + (1,) * (3 - len(d))


class Kernel:
    """One launchable kernel of a :class:`CudaModule` (≙
    ``rtc.CudaModule.Kernel``)."""

    launches = 0        # every rtc launch in this process

    def __init__(self, module: "CudaModule", name: str, params: List[Param],
                 n_outputs: int, template: Optional[str]):
        self.module = module
        self.name = name
        self.params = params
        self.n_outputs = n_outputs
        self.template = template     # the type parameter bound to out_dtype
        ptr_idx = [i for i, p in enumerate(params) if p.pointer]
        if n_outputs < 0 or n_outputs > len(ptr_idx):
            raise ValueError(f"kernel {name!r} has {len(ptr_idx)} pointer "
                             f"parameters, cannot have {n_outputs} outputs")
        self._outs = ptr_idx[len(ptr_idx) - n_outputs:]
        self._ins = [p for i, p in enumerate(params) if i not in self._outs]
        for i in self._outs:
            if params[i].const:
                raise ValueError(f"kernel {name!r}: output parameter "
                                 f"{params[i].name!r} points to const")

    def __repr__(self):
        sig = ", ".join(f"{'const ' if p.const else ''}{p.ctype} "
                        f"{'*' if p.pointer else ''}{p.name}"
                        for p in self.params)
        return f"<rtc.Kernel {self.name}({sig})>"

    def _dtype(self, ctype, bound):
        if ctype == self.template:
            return bound
        return _TYPES[ctype][0]

    def launch(self, args, grid=None, block=None, shared_mem: int = 0,
               out_shape=None, out_dtype=None, block_shapes=None,
               out_block_shape=None):
        """Launch on the CUDA tensors of ``args`` and return the outputs
        (one tensor, a tuple for several, None for none)."""
        if block_shapes is not None or out_block_shape is not None:
            raise ValueError(
                "block_shapes: a TPU BlockSpec has no CUDA counterpart; "
                "pass grid= and block= and index with blockIdx/threadIdx "
                "in the kernel")
        grid, block = _dims(grid, "grid"), _dims(block, "block")
        outs_at, ins = self._outs, self._ins
        args = list(args)
        if len(args) != len(ins):
            raise TypeError(f"{self.name} takes {len(ins)} arguments "
                            f"({', '.join(p.name for p in ins)}); the "
                            f"{self.n_outputs} output(s) are allocated; got "
                            f"{len(args)}")
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        for t in tensors:
            if t.device.type != "cuda":
                raise ValueError(
                    f"{self.name}: a {t.device.type} tensor; rtc kernels "
                    "are CUDA source and run on CUDA tensors only")
        device = tensors[0].device if tensors else \
            torch.device("cuda", torch.cuda.current_device())
        # the template parameter follows out_dtype, else its first tensor
        bound = None
        if self.template is not None:
            bound = out_dtype
            if bound is None:
                for p, a in zip(ins, args):
                    if p.pointer and p.ctype == self.template and \
                            isinstance(a, torch.Tensor):
                        bound = a.dtype
                        break
            if bound not in _CTYPE_OF:
                raise TypeError(f"{self.name}: template parameter "
                                f"{self.template} needs out_dtype (one of "
                                f"{list(_CTYPE_OF)}), got {bound}")
        shapes = _per_output(out_shape, self.n_outputs, "out_shape",
                             tensors[0].shape if tensors else None)
        dtypes = _per_output(out_dtype, self.n_outputs, "out_dtype", None)
        outputs = []
        for k, i in enumerate(self._outs):
            want = self._dtype(self.params[i].ctype, bound)
            dt = dtypes[k] if dtypes[k] is not None else want
            if dt is None:
                dt = torch.float32      # a void* output: the JAX default
            if want is not None and dt != want:
                raise TypeError(f"{self.name}: out_dtype {dt} does not match "
                                f"parameter {self.params[i].name!r} "
                                f"({self.params[i].ctype} *)")
            if shapes[k] is None:
                raise ValueError(f"{self.name}: out_shape is needed when no "
                                 "argument is a tensor")
            outputs.append(torch.empty(tuple(shapes[k]), dtype=dt,
                                       device=device))
        cargs, it_in, it_out = [], iter(args), iter(outputs)
        for i, p in enumerate(self.params):
            a = next(it_out) if i in outs_at else next(it_in)
            cargs.append(self._carg(p, a, device, bound))
        if self.template is not None:
            expr = f"{self.name}<{_CTYPE_OF[bound]}>"
        else:
            expr = self.name
        fn = self.module.function(expr, device.index)
        stream = torch.cuda.current_stream(device).cuda_stream
        _nvrtc.launch(fn, grid, block, shared_mem, stream, cargs,
                      device.index)
        with _count_mu:
            Kernel.launches += 1
        if not outputs:
            return None
        return outputs[0] if len(outputs) == 1 else tuple(outputs)

    def _carg(self, p: Param, a, device, bound):
        if p.pointer:
            if not isinstance(a, torch.Tensor):
                raise TypeError(f"{self.name}: parameter {p.name!r} "
                                f"({p.ctype} *) takes a tensor, got "
                                f"{type(a).__name__}")
            if a.device != device:
                raise ValueError(f"{self.name}: {p.name!r} is on {a.device},"
                                 f" the launch is on {device}")
            if not a.is_contiguous():
                raise ValueError(f"{self.name}: {p.name!r} is not "
                                 "contiguous")
            want = self._dtype(p.ctype, bound)
            if want is not None and a.dtype != want:
                raise TypeError(f"{self.name}: {p.name!r} is {a.dtype}, the "
                                f"signature says {p.ctype} * ({want})")
            return ctypes.c_void_p(a.data_ptr())
        if isinstance(a, torch.Tensor):
            raise TypeError(f"{self.name}: parameter {p.name!r} "
                            f"({p.ctype}) takes a number, got a tensor")
        if p.ctype == self.template:
            raise TypeError(f"{self.name}: scalar {p.name!r} of template "
                            f"type {p.ctype} is not supported")
        ctor = _TYPES[p.ctype][1]
        if ctor is None:
            raise TypeError(f"{self.name}: no scalar conversion for "
                            f"{p.ctype} ({p.name!r})")
        if ctor in (ctypes.c_float, ctypes.c_double):
            if isinstance(a, bool) or not isinstance(a, (int, float)) and \
                    not hasattr(a, "__float__"):
                raise TypeError(f"{self.name}: {p.name!r} ({p.ctype}) takes "
                                f"a number, got {type(a).__name__}")
            return ctor(float(a))
        if ctor is ctypes.c_bool:
            return ctor(bool(a))
        if isinstance(a, float) or not hasattr(a, "__index__"):
            raise TypeError(f"{self.name}: {p.name!r} ({p.ctype}) takes an "
                            f"integer, got {type(a).__name__}")
        v = ctor(int(a))
        if v.value != int(a):
            raise ValueError(f"{self.name}: {p.name!r} = {int(a)} does not "
                             f"fit {p.ctype}")
        return v


def _per_output(value, n, what, default):
    """``value`` given once for every output, or once per output."""
    if n > 1 and isinstance(value, (list, tuple)) and value and \
            (value[0] is None or isinstance(value[0], (list, tuple, torch.Size,
                                                       torch.dtype))):
        if len(value) != n:
            raise ValueError(f"{what}: {len(value)} values for {n} outputs")
        return [default if v is None else v for v in value]
    return [default if value is None else value] * n


class CudaModule:
    """CUDA C++ source compiled by NVRTC (≙ upstream ``rtc.CudaModule``).

    ``options`` are NVRTC options (the arch, ``sm_90a``, is added);
    ``exports`` are kernels that are not ``extern "C"``, such as template
    instantiations, by their C++ name expression.  The source compiles
    at the first launch, never here."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if not isinstance(source, str):
            raise TypeError("CudaModule takes CUDA C++ source text")
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self.compiles = 0           # NVRTC programs built (or read cached)
        self.programs = {}          # extra name expression (or None) -> Cubin
        self._mu = threading.Lock()

    def get_kernel(self, name: str, signature: Optional[str] = None,
                   n_outputs: int = 1) -> Kernel:
        """The kernel ``name`` (≙ ``CudaModule.get_kernel(name,
        signature)``); ``signature`` defaults to the source's."""
        base, targs = _split_name(name)
        decl = _declaration(self.source, base)
        tparams = decl[0] if decl else []
        if signature is None:
            if decl is None:
                raise ValueError(
                    f"no __global__ void {base}(...) in the source; pass "
                    "signature=")
            signature = decl[1]
        template = None
        if targs is not None:
            if len(targs) != len(tparams):
                raise ValueError(f"{name}: {len(targs)} template arguments "
                                 f"for parameters {tparams}")
            for t in targs:
                if t not in _TYPES:
                    raise ValueError(f"{name}: unknown type {t!r}")
            subst = dict(zip(tparams, targs))
            params = [p._replace(ctype=subst.get(p.ctype, p.ctype))
                      for p in parse_signature(signature, tparams)]
        else:
            if len(tparams) > 1:
                raise ValueError(f"{name}: templated on {tparams}; a kernel "
                                 "binds one type parameter to out_dtype, "
                                 "name the others as name<...>")
            params = parse_signature(signature, tparams)
            template = tparams[0] if tparams else None
        return Kernel(self, name if targs is None else
                      f"{base}<{', '.join(targs)}>", params, n_outputs,
                      template)

    def _cubin(self, expr: Optional[str]):
        key = None if expr is None or expr in self.exports else expr
        cub = self.programs.get(key)
        if cub is None:
            with self._mu:
                cub = self.programs.get(key)
                if cub is None:
                    exprs = self.exports + ((key,) if key else ())
                    cub = _nvrtc.compile_program(self.source, self.options,
                                                 exprs)
                    self.programs[key] = cub
                    self.compiles += 1
        return cub

    def function(self, name: str, device: int):
        """The driver function of kernel ``name`` (an ``extern "C"`` name
        or a name expression) on ``device``, compiled and loaded once."""
        expr = name if (name in self.exports or "<" in name) else None
        cub = self._cubin(expr)
        symbol = cub.lowered[name] if expr else name
        return _nvrtc.load_function(cub, symbol, device)


def PallasModule(*args, **kwargs):
    """≙ ``mx.rtc.PallasModule`` — refused with a migration hint: Pallas
    kernel functions are TPU code (the JAX package's ``CudaModule``
    refuses CUDA source the same way)."""
    raise RuntimeError(
        "PallasModule compiles Pallas (Python) kernels for a TPU; on the "
        "CUDA build use mxnet_tpu_torch.rtc.CudaModule with CUDA C++ "
        "source instead")
