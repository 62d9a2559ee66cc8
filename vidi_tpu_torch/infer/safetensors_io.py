"""The safetensors format, read and written without the `safetensors` package.

A file is an 8-byte little-endian header length N, N bytes of JSON, then the
data. The JSON maps each tensor's name to its `dtype`, `shape` and
`data_offsets` [begin, end) (relative to the end of the header), plus an
optional `__metadata__` of strings. The writer pads the header with spaces
to a multiple of 8, as the library does.

Reading is lazy: `Index` (one or more files; `load_safetensors_dir` gives
every `*.safetensors` shard of a directory, sorted) maps names to
`TensorRef`s, and a tensor is read only when `Index.load` asks for it: for a
CUDA target its bytes go with `readinto`, STAGE_BYTES at a time, through
the index's page-locked buffer onto the device, so a load holds that
buffer on the host, not the model, and gives it back to the system when
the index (one load) ends. BF16 is read as raw 16-bit words and viewed as
`torch.bfloat16`; nothing goes through numpy's dtypes. The writer
(`save_file`) takes the tensors one at a time, through a buffer of the
same size, and makes a `Deferred` one only as it writes it, so it never
holds a host copy of the whole tree either. A malformed file (a header
length past the file, bad JSON, an unknown dtype, offsets that overlap,
leave the data or disagree with the shape) raises ValueError naming the
file.
"""
from __future__ import annotations

import json
import math
import os
import weakref
from typing import Callable, Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}
# a header larger than this is refused before it is read (the library's limit)
MAX_HEADER_BYTES = 100_000_000
# bytes a load or save moves between the file and a card at a time. A
# buffer as large as the 9B's largest tensor (1.84 GB), page-locked anew for
# each load, made a load of the 9B ~1.7 s slower on an H100 host than one
# that reused a cached pinned block.
STAGE_BYTES = 64 << 20


def _staging(buf: torch.Tensor, nbytes: int) -> torch.Tensor:
    """`buf` if it holds `nbytes`, else a new page-locked uint8 host buffer
    that does, to carry bytes to and from a card: a plain host tensor
    registered with CUDA and unregistered when it dies, so that its memory
    goes back to the system with it (torch's pinned allocator would keep
    it cached for the life of the process)."""
    if buf.numel() >= nbytes:
        return buf
    buf = torch.empty(nbytes, dtype=torch.uint8)
    cudart = torch.cuda.cudart()
    torch.cuda.check_error(cudart.cudaHostRegister(buf.data_ptr(), nbytes, 0))
    weakref.finalize(buf, cudart.cudaHostUnregister, buf.data_ptr())
    return buf


class TensorRef(NamedTuple):
    """Where one tensor's bytes lie: file, absolute byte offset, length."""

    path: str
    offset: int
    nbytes: int
    dtype: torch.dtype
    shape: Tuple[int, ...]


class Deferred(NamedTuple):
    """A tensor that `save_file` makes only when it writes it (an export's
    dequantized leaf), so that no more than one is alive at a time."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    make: Callable[[], torch.Tensor]


def nbytes(value) -> int:
    """The bytes a tensor or a Deferred takes in a file."""
    return math.prod(value.shape) * value.dtype.itemsize


def _parse_header(path: str, file_size: int, n: int, text: bytes):
    """-> ({name: TensorRef}, metadata), or ValueError naming `path`."""
    try:
        header = json.loads(text.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    metadata = header.pop("__metadata__", None)
    if metadata is not None and not (
            isinstance(metadata, dict)
            and all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items())):
        raise ValueError(f"{path}: __metadata__ must map strings to strings")
    data_start, data_len = 8 + n, file_size - 8 - n
    refs, spans = {}, []
    for name, entry in header.items():
        if not isinstance(entry, dict) or set(entry) != {"dtype", "shape", "data_offsets"}:
            raise ValueError(f"{path}: tensor {name!r} needs exactly dtype, shape and "
                             f"data_offsets, got {entry!r}")
        if entry["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unknown dtype {entry['dtype']!r}")
        shape, offs = entry["shape"], entry["data_offsets"]
        if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError(f"{path}: tensor {name!r} has a bad shape {shape!r}")
        if not (isinstance(offs, list) and len(offs) == 2
                and all(isinstance(o, int) for o in offs) and 0 <= offs[0] <= offs[1]):
            raise ValueError(f"{path}: tensor {name!r} has bad data_offsets {offs!r}")
        dtype = DTYPES[entry["dtype"]]
        size = math.prod(shape) * dtype.itemsize
        if offs[1] - offs[0] != size:
            raise ValueError(f"{path}: tensor {name!r} spans {offs[1] - offs[0]} bytes, "
                             f"its dtype and shape need {size}")
        if offs[1] > data_len:
            raise ValueError(f"{path}: tensor {name!r} ends at byte {offs[1]} of a "
                             f"{data_len}-byte data section")
        refs[name] = TensorRef(path, data_start + offs[0], size, dtype, tuple(shape))
        spans.append((offs[0], offs[1], name))
    spans.sort()
    for (_, end, a), (begin, _, b) in zip(spans, spans[1:]):
        if begin < end:
            raise ValueError(f"{path}: tensors {a!r} and {b!r} overlap")
    return refs, metadata or {}


def _read_header(path: str):
    """-> ({name: TensorRef}, metadata) of one file, or ValueError naming it."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a header length")
        n = int.from_bytes(head, "little")
        if n == 0 or n > MAX_HEADER_BYTES or 8 + n > size:
            raise ValueError(f"{path}: header length {n} does not fit a "
                             f"{size}-byte file")
        text = f.read(n)
    return _parse_header(path, size, n, text)


class Index(Mapping):
    """The tensors of one or more files by name -> TensorRef (lazy; see the
    module docstring); a name in two files raises. `shards` holds each
    file's (path, metadata). The page-locked buffer that `load` reads
    through lives as long as the index, which is one load."""

    def __init__(self, paths):
        self.refs: Dict[str, TensorRef] = {}
        self.shards = []
        for path in paths:
            refs, metadata = _read_header(path)
            for name, ref in refs.items():
                if name in self.refs:
                    raise ValueError(f"{path}: tensor {name!r} is also in "
                                     f"{self.refs[name].path}")
                self.refs[name] = ref
            self.shards.append((path, metadata))
        self._stage = torch.empty(0, dtype=torch.uint8)

    def __getitem__(self, name: str) -> TensorRef:
        return self.refs[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self.refs)

    def __len__(self) -> int:
        return len(self.refs)

    def load(self, name: str, device) -> torch.Tensor:
        """Read tensor `name` onto `device`: straight into it on the CPU,
        through the page-locked buffer onto a card."""
        ref, dev = self.refs[name], torch.device(device)
        out = torch.empty(ref.nbytes, dtype=torch.uint8, device=dev)
        if dev.type == "cuda":
            self._stage = _staging(self._stage, min(ref.nbytes, STAGE_BYTES))
        with open(ref.path, "rb") as f:
            f.seek(ref.offset)
            for begin in range(0, ref.nbytes, STAGE_BYTES):
                part = out[begin:begin + STAGE_BYTES]
                host = self._stage[:part.numel()] if dev.type == "cuda" else part
                got = f.readinto(memoryview(host.numpy()))
                if got != part.numel():
                    raise ValueError(f"{ref.path}: short read ({begin + got} of "
                                     f"{ref.nbytes} bytes)")
                if host is not part:
                    part.copy_(host)  # synchronous: the buffer is free again after it
        return out.view(ref.dtype).reshape(ref.shape)


def load_safetensors_dir(path: str) -> Index:
    """Every `*.safetensors` shard of `path`, sorted, as one lazy index."""
    shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no safetensors shards in {path}")
    return Index([os.path.join(path, s) for s in shards])


def _write(f, value, stage: torch.Tensor) -> torch.Tensor:
    """Write one tensor (a Deferred is made here, and dies on return),
    STAGE_BYTES at a time through `stage` when it lies on a card. -> the
    staging buffer, grown if it had to be."""
    t = value.make() if isinstance(value, Deferred) else value
    if t.dtype != value.dtype or tuple(t.shape) != tuple(value.shape):
        raise ValueError(f"a Deferred of {value.dtype} {tuple(value.shape)} made "
                         f"{t.dtype} {tuple(t.shape)}")
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if not flat.is_cuda:
        f.write(memoryview(flat.numpy()))
        return stage
    stage = _staging(stage, min(flat.numel(), STAGE_BYTES))
    for begin in range(0, flat.numel(), STAGE_BYTES):
        part = flat[begin:begin + STAGE_BYTES]
        host = stage[:part.numel()]
        host.copy_(part)
        f.write(memoryview(host.numpy()))
    return stage


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` (tensors on any device, or Deferreds) to `path`, one
    at a time, then fsync. Tensors on a card pass through one page-locked
    buffer of this call. -> bytes written."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in NAMES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {t.dtype}, which "
                             "safetensors cannot hold")
        n = nbytes(t)
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    stage = torch.empty(0, dtype=torch.uint8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for name in names:
            stage = _write(f, tensors[name], stage)
        f.flush()
        os.fsync(f.fileno())
    return 8 + len(text) + offset
