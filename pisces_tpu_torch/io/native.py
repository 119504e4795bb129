"""ctypes binding for the port's C++ host module (libpisces_io).

The sources are io/_native/*.cpp: pisces_io.cpp (BGZF inflate, columnar BAM
decode with typed tags, the lazy .bai region fetch, the pileup pass with SNV
mismatch extraction and the gVCF tuple dedup, reference-line rendering, the
threaded BGZF deflater), rmxn.cpp (the RMxN repeat scan), stitch.cpp
(Gemini's read-pair stitcher, one pair or a columnar batch, and the
realigner's alignment summary) and realign.cpp (the realigner's per-read
core). get_lib() builds them with g++ at first use into
pisces_tpu_torch/build/libpisces_io-<hash>.so, named by a hash of the
sources, the flags and the host CPU, so a stale or foreign build never
loads. A failed build raises with the compiler's output: open_bam never
falls back to the Python reader unless the caller asks for it
(prefer_native=False).

The build, the ctypes bindings and the pileup count are shared by every
thread of the process and taken under a lock; each reader handle belongs
to one thread at a time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import numpy as np

from pisces_tpu_torch.options import REGION_SIZE

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_native")
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
LINK_FLAGS = ("-lz", "-lpthread")

# native_pileup calls since the last reset (chip_smoke.py reads it to show
# the main path took the native flow), counted under _count_lock
pileup_calls = 0
_count_lock = threading.Lock()
# guards the first build and every ctypes binding: two threads that start
# them at once would each compile, or set signatures mid-call
_lock = threading.Lock()


def reset_pileup_calls() -> None:
    global pileup_calls
    with _count_lock:
        pileup_calls = 0


class NativeLibrary:
    """The loaded library, where it was built from, and how."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.lib = ctypes.CDLL(path)   # RTLD_LOCAL: no symbol clashes


_native: Optional[NativeLibrary] = None


def _sources():
    return sorted(os.path.join(_NATIVE_DIR, f)
                  for f in os.listdir(_NATIVE_DIR) if f.endswith(".cpp"))


def _host_cpu() -> bytes:
    """The CPU's flags line: -march=native code is built for this CPU."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def _build_hash(sources, flags, extra: bytes = b"") -> str:
    """12 hex digits of the sources, the compiler line and `extra`."""
    digest = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    digest.update(" ".join((CXX, *flags, *LINK_FLAGS)).encode())
    digest.update(extra)
    return digest.hexdigest()[:12]


def library_path() -> str:
    return os.path.join(BUILD_DIR, "libpisces_io-"
                        f"{_build_hash(_sources(), CXX_FLAGS, _host_cpu())}.so")


def build_native() -> NativeLibrary:
    """Build (once per source, flag and CPU set) and load the library.
    Threads build once, under a lock; concurrent processes each compile to
    a temporary file and os.replace it into place; a failed build raises
    RuntimeError with g++'s output."""
    with _lock:
        return _build_native()


def _build_native() -> NativeLibrary:
    global _native
    if _native is not None:
        return _native
    path = library_path()
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(path):
        log = _compile(path, CXX_FLAGS, _sources(), "the native host module")
    _native = NativeLibrary(path, time.perf_counter() - t0, log)
    return _native


def _compile(path: str, flags, sources, what: str) -> str:
    """g++ `sources` with `flags` into `path` (through a temporary file in
    BUILD_DIR, os.replace'd into place); returns g++'s output and raises
    RuntimeError with it if the build fails."""
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the port's native host "
                           "module builds with g++ and zlib at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=os.path.splitext(path)[1],
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *flags, *sources, "-o", tmp, *LINK_FLAGS],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed building {what} from "
                               f"{_NATIVE_DIR}:\n{log}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return log


# The ThreadSanitizer harness (io/_native/tsan/tsan_check.cpp): outside
# the directory _sources() globs, so the library never links its main()
TSAN_SOURCE = os.path.join(_NATIVE_DIR, "tsan", "tsan_check.cpp")
TSAN_FLAGS = ("-O1", "-g", "-fsanitize=thread", "-fPIC", "-std=c++17",
              "-Wall")


def build_tsan_check() -> str:
    """Build the ThreadSanitizer harness with the library's sources into
    BUILD_DIR/tsan_check-<hash> (hash of the sources and flags) at first
    use; returns its path. A failed build raises RuntimeError with g++'s
    output. Run: tsan_check <bam> [n_threads] [iters] [ref_codes]."""
    sources = [*_sources(), TSAN_SOURCE]
    path = os.path.join(BUILD_DIR,
                        f"tsan_check-{_build_hash(sources, TSAN_FLAGS)}")
    with _lock:
        if not os.path.exists(path):
            _compile(path, TSAN_FLAGS, sources, "the ThreadSanitizer harness")
    return path


def get_lib() -> ctypes.CDLL:
    """The bound library; builds it at first use and raises if it cannot."""
    lib = build_native().lib
    with _lock:
        if not getattr(lib, "_bound", False):
            _bind(lib)
    return lib


def _bind(lib) -> None:
    """Every export's ctypes signature, set once per library."""
    lib.bam_open.restype = ctypes.c_void_p
    lib.bam_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bam_close.argtypes = [ctypes.c_void_p]
    lib.bam_n_refs.argtypes = [ctypes.c_void_p]
    lib.bam_ref_name.restype = ctypes.c_char_p
    lib.bam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bam_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bam_n_records.restype = ctypes.c_int64
    lib.bam_n_records.argtypes = [ctypes.c_void_p]
    lib.bam_header_text.restype = ctypes.c_void_p
    lib.bam_header_text.argtypes = [ctypes.c_void_p]
    lib.bam_header_text_len.restype = ctypes.c_int64
    lib.bam_header_text_len.argtypes = [ctypes.c_void_p]
    lib.bam_decode_tags.restype = ctypes.c_int64
    lib.bam_decode_tags.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
    for name, ct in [("bam_col_ref_id", ctypes.c_int32),
                     ("bam_col_pos", ctypes.c_int32),
                     ("bam_col_end_pos", ctypes.c_int32),
                     ("bam_col_mapq", ctypes.c_uint8),
                     ("bam_col_flag", ctypes.c_uint16),
                     ("bam_col_cigar_off", ctypes.c_int64),
                     ("bam_col_cigar_ops", ctypes.c_uint8),
                     ("bam_col_cigar_lens", ctypes.c_int32),
                     ("bam_col_seq_off", ctypes.c_int64),
                     ("bam_col_seq", ctypes.c_int8),
                     ("bam_col_qual", ctypes.c_uint8),
                     ("bam_col_mate_ref_id", ctypes.c_int32),
                     ("bam_col_mate_pos", ctypes.c_int32),
                     ("bam_col_tag_off", ctypes.c_int64),
                     ("bam_col_xv_val", ctypes.c_int32),
                     ("bam_col_xw_val", ctypes.c_int32),
                     ("bam_col_tag_present", ctypes.c_uint8)]:
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ct)
        fn.argtypes = [ctypes.c_void_p]
    lib.bam_col_tag_off.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bam_col_name_off.restype = ctypes.POINTER(ctypes.c_int64)
    lib.bam_col_name_off.argtypes = [ctypes.c_void_p]
    lib.bam_col_name_blob.restype = ctypes.c_void_p
    lib.bam_col_name_blob.argtypes = [ctypes.c_void_p]
    lib.bam_col_tag_blob.restype = ctypes.c_void_p
    lib.bam_col_tag_blob.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bam_total_cigar.restype = ctypes.c_int64
    lib.bam_total_cigar.argtypes = [ctypes.c_void_p]
    lib.bam_total_bases.restype = ctypes.c_int64
    lib.bam_total_bases.argtypes = [ctypes.c_void_p]
    lib.bam_open_lazy.restype = ctypes.c_void_p
    lib.bam_open_lazy.argtypes = [ctypes.c_char_p]
    lib.bam_fetch_region.restype = ctypes.c_int64
    lib.bam_fetch_region.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64]
    lib.bam_pileup_mm.restype = ctypes.c_int64
    lib.bam_pileup_mm.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64, ctypes.c_int]
    lib.pileup_n_mismatches.restype = ctypes.c_int64
    lib.pileup_n_mismatches.argtypes = [ctypes.c_void_p]
    lib.pileup_has_pos_tuples.restype = ctypes.c_int64
    lib.pileup_has_pos_tuples.argtypes = [ctypes.c_void_p]
    lib.pileup_gvcf_unique.restype = ctypes.c_int64
    lib.pileup_gvcf_unique.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int64]
    lib.pileup_n_uniq.restype = ctypes.c_int64
    lib.pileup_n_uniq.argtypes = [ctypes.c_void_p]
    for name, ct in [("pileup_mm_gpos", ctypes.c_int64),
                     ("pileup_mm_alt", ctypes.c_int8),
                     ("pileup_mm_dir", ctypes.c_int8),
                     ("pileup_mm_flags", ctypes.c_int8),
                     ("pileup_block_keys", ctypes.c_int64),
                     ("pileup_counts_t", ctypes.c_int32),
                     ("pileup_qual_t", ctypes.c_double),
                     ("pileup_anchored_counts", ctypes.c_int32),
                     ("pileup_anchored_quals", ctypes.c_double),
                     ("pileup_pos_tuples", ctypes.c_int32),
                     ("pileup_sel_positions", ctypes.c_int64),
                     ("pileup_uniq_tuples", ctypes.c_int32),
                     ("pileup_uniq_inv", ctypes.c_int32)]:
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ct)
        fn.argtypes = [ctypes.c_void_p]
    lib.render_ref_lines.restype = ctypes.c_void_p
    lib.render_ref_lines.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64)]
    lib.rl_blob_len.restype = ctypes.c_int64
    lib.rl_blob_len.argtypes = [ctypes.c_void_p]
    lib.rl_blob.restype = ctypes.c_void_p
    lib.rl_blob.argtypes = [ctypes.c_void_p]
    lib.rl_line_off.restype = ctypes.POINTER(ctypes.c_int64)
    lib.rl_line_off.argtypes = [ctypes.c_void_p]
    lib.rl_free.argtypes = [ctypes.c_void_p]
    lib.bgzf_compress.restype = ctypes.c_void_p
    lib.bgzf_compress.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int]
    for name, ct in [("bgzfc_data_len", ctypes.c_int64),
                     ("bgzfc_n_blocks", ctypes.c_int64)]:
        fn = getattr(lib, name)
        fn.restype = ct
        fn.argtypes = [ctypes.c_void_p]
    lib.bgzfc_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.bgzfc_data.argtypes = [ctypes.c_void_p]
    lib.bgzfc_block_off.restype = ctypes.POINTER(ctypes.c_int64)
    lib.bgzfc_block_off.argtypes = [ctypes.c_void_p]
    lib.bgzfc_free.argtypes = [ctypes.c_void_p]
    lib.rmxn_min_component.restype = ctypes.c_int
    lib.rmxn_min_component.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # preprocessing/stitcher.py
    lib.stitch_pair.restype = ci
    lib.stitch_pair.argtypes = [
        i64, vp, vp, ci, vp, vp, ci,
        i64, vp, vp, ci, vp, vp, ci,
        ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci]
    lib.stitch_pairs_batch.restype = ci
    lib.stitch_pairs_batch.argtypes = (
        [i64, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci]
        + [ci] * 9
        + [vp, vp, vp, vp, vp, i64, vp, vp, vp, i64, vp, vp, i64, vp])
    # preprocessing/realigner.py
    lib.aln_summary.restype = ci
    lib.aln_summary.argtypes = [
        ctypes.c_char_p, i64, i64, vp, vp, ci, ctypes.c_char_p, ci, vp]
    lib.realign_anchor.restype = ci
    lib.realign_anchor.argtypes = (
        [vp, i64,                  # ref
         i64, i64, i64, i64, i64,  # details
         vp, vp, i64,              # seq/quals/len
         i64] + [vp] * 6           # indel scalar arrays
        + [vp] + [vp] * 4          # pool + 4 offset arrays
        + [ci, ci]                 # anchor_left, pair_specific
        + [ci] * 5 + [i64, ctypes.c_double, i64]  # config
        + [vp] * 8 + [ci])         # outputs
    lib._bound = True


def _as_array(ptr, n, dtype):
    """Copy a C buffer into a fresh ndarray with one memcpy (the dtype's
    itemsize matches the pointer's element type by the restypes above)."""
    if n == 0:
        return np.empty(0, dtype=dtype)
    out = np.empty(n, dtype=dtype)
    ctypes.memmove(out.ctypes.data, ctypes.addressof(ptr.contents), out.nbytes)
    return out


def _as_view(ptr, n, dtype):
    """Zero-copy read-only ndarray view over a C buffer: nothing is
    allocated or faulted in. It is valid until the owning handle's next
    decode or pileup, or its close; callers consume it before either, and
    copy it before it becomes a tensor (torch.from_numpy would alias memory
    that C++ overwrites)."""
    if n == 0:
        return np.empty(0, dtype=dtype)
    dtype = np.dtype(dtype)
    buf = (ctypes.c_char * (n * dtype.itemsize)).from_address(
        ctypes.addressof(ptr.contents))
    arr = np.frombuffer(buf, dtype=dtype, count=n)
    arr.flags.writeable = False
    return arr


class NativeBamReader:
    """Native counterpart of io.bam.BamReader with the same fetch()
    contract. By default the whole file inflates in C++ threads at open,
    and each fetch decodes one chromosome (or all) into columnar arrays.

    lazy=True keeps the file compressed (mapped) and serves fetch_region()
    through the sibling .bai: only the BGZF chunks the index maps to the
    window inflate (the reference's BamReader.Jump,
    Alignment.IO/BamReader.cs:22-677), the bounded-memory streaming mode of
    -WindowSize. A lazy handle holds only its last window's reads, so it
    has no fetch()."""

    def __init__(self, path: str, lazy: bool = False):
        from pisces_tpu_torch.io.bam import BamHeader
        lib = get_lib()
        self._lib = lib
        self._lazy = lazy
        self._bai = None
        self._n_decoded = None   # reads of the last fetch, held by the handle
        if lazy:
            self._h = lib.bam_open_lazy(path.encode())
        else:
            self._h = lib.bam_open(path.encode(),
                                   min(os.cpu_count() or 1, 16))
        if not self._h:
            raise IOError(f"failed to open {path}")
        n_refs = lib.bam_n_refs(self._h)
        names = [lib.bam_ref_name(self._h, i).decode() for i in range(n_refs)]
        lens = [lib.bam_ref_len(self._h, i) for i in range(n_refs)]
        tlen = lib.bam_header_text_len(self._h)
        text = ctypes.string_at(lib.bam_header_text(self._h), tlen).decode(
            "utf-8", errors="replace")
        self.header = BamHeader(text, names, lens)
        self.path = path

    @property
    def n_records(self) -> int:
        return int(self._lib.bam_n_records(self._h))

    def index(self):
        """The sibling .bai (io/bai.BamIndex), read once; None without one."""
        if self._bai is None:
            from pisces_tpu_torch.io.bai import read_sibling_bai
            self._bai = read_sibling_bai(self.path) or False
        return self._bai or None

    def fetch(self, ref_id: Optional[int] = None, parse_tags: bool = False,
              as_views: bool = False, parse_names: bool = False):
        """Decode the records of ref_id (None: all). as_views=True serves
        the base-sized columns (seq/qual/cigar) as zero-copy views into the
        handle's decode buffers, valid until the next fetch on this handle
        (native_pileup does not invalidate them); the single-pass caller
        path opts in, every other caller gets copies. parse_names=True
        also decodes the read names (Gemini pairs mates by name)."""
        if self._lazy:
            raise ValueError(f"{self.path}: a lazy reader serves "
                             "fetch_region() only")
        n = int(self._lib.bam_decode_tags(
            self._h, -1 if ref_id is None else ref_id,
            1 if parse_tags else 0))
        return self._batch(n, parse_tags, as_views, parse_names)

    def _batch(self, n: int, parse_tags: bool, as_views: bool,
               parse_names: bool = False):
        """The ReadBatch of the handle's n decoded records."""
        from pisces_tpu_torch.io.bam import ReadBatch
        lib = self._lib
        h = self._h
        self._n_decoded = n
        total_cigar = int(lib.bam_total_cigar(h))
        total_bases = int(lib.bam_total_bases(h))
        big = _as_view if as_views else _as_array
        xd_tags = xn_tags = extra_tags = None
        if parse_tags:
            xd_tags, xn_tags, extra_tags = self._build_tag_lists(n)
        names = None
        if parse_names:
            name_off = _as_array(lib.bam_col_name_off(h), n + 1, np.int64)
            blob = ctypes.string_at(lib.bam_col_name_blob(h),
                                    int(name_off[-1])) if n else b""
            names = [blob[name_off[i]:name_off[i + 1]].decode(
                "ascii", errors="replace") for i in range(n)]
        batch = ReadBatch(
            n=n,
            ref_id=_as_array(lib.bam_col_ref_id(h), n, np.int32),
            pos=_as_array(lib.bam_col_pos(h), n, np.int32),
            mapq=_as_array(lib.bam_col_mapq(h), n, np.uint8),
            flag=_as_array(lib.bam_col_flag(h), n, np.uint16),
            cigar_off=_as_array(lib.bam_col_cigar_off(h), n + 1, np.int64),
            cigar_ops=big(lib.bam_col_cigar_ops(h), total_cigar, np.uint8),
            cigar_lens=big(lib.bam_col_cigar_lens(h), total_cigar, np.int32),
            seq_off=_as_array(lib.bam_col_seq_off(h), n + 1, np.int64),
            seq=big(lib.bam_col_seq(h), total_bases, np.int8),
            qual=big(lib.bam_col_qual(h), total_bases, np.uint8),
            end_pos=_as_array(lib.bam_col_end_pos(h), n, np.int32),
            xd_tags=xd_tags,
            xn_tags=xn_tags,
            extra_tags=extra_tags,
            names=names,
            mate_ref_id=_as_array(lib.bam_col_mate_ref_id(h), n, np.int32),
            mate_pos=_as_array(lib.bam_col_mate_pos(h), n, np.int32),
        )
        batch._from_native_handle = True
        return batch

    def _build_tag_lists(self, n: int):
        """xd/xn/extra tag lists from the native tag columns (the Python
        reader's _parse_string_tags contract)."""
        lib = self._lib
        if n == 0:
            return [], [], []
        present = _as_array(lib.bam_col_tag_present(self._h), n, np.uint8)
        offs = {}
        blobs = {}
        for slot, name in enumerate(("xd", "xn", "xr", "xu", "xw_s")):
            o = _as_array(lib.bam_col_tag_off(self._h, slot), n + 1, np.int64)
            offs[name] = o
            blobs[name] = (ctypes.string_at(
                lib.bam_col_tag_blob(self._h, slot), int(o[-1]))
                if o[-1] else b"")
        xv = _as_array(lib.bam_col_xv_val(self._h), n, np.int32)
        xw = _as_array(lib.bam_col_xw_val(self._h), n, np.int32)

        def s(name, i):
            o = offs[name]
            return blobs[name][o[i]:o[i + 1]].decode("ascii",
                                                     errors="replace")

        xd_tags, xn_tags, extra = [], [], []
        for i, p in enumerate(present.tolist()):
            tags = {}
            xd = s("xd", i) if p & 1 else None
            xn = s("xn", i) if p & 2 else None
            if xd is not None:
                tags["XD"] = xd
            if xn is not None:
                tags["XN"] = xn
            if p & 4:
                tags["XR"] = s("xr", i)
            if p & 8:
                tags["XU"] = s("xu", i)
            if p & 16:
                tags["XV"] = int(xv[i])
            if p & 32:
                tags["XW"] = int(xw[i])
            if p & 64:  # Z-typed XW overrides an int XW (parser order)
                tags["XW"] = s("xw_s", i)
            xd_tags.append(xd)
            xn_tags.append(xn)
            extra.append(tags)
        return xd_tags, xn_tags, extra

    def fetch_region(self, ref_id: int, beg0: int, end0: int,
                     parse_tags: bool = False, as_views: bool = False,
                     parse_names: bool = False):
        """Reads of ref_id overlapping [beg0, end0) (0-based half-open).

        A lazy reader queries the .bai (IOError without one) and inflates
        only those chunks in C++, where the overlap filter also runs, so
        the handle's decoded batch stays one-to-one with the returned one
        (native_pileup reads it); as_views as in fetch(). A whole-file
        reader decodes the chromosome and masks it (copies, which the
        native pileup does not take)."""
        if not self._lazy:
            from pisces_tpu_torch.io.bam import subset_batch
            batch = self.fetch(ref_id, parse_tags, parse_names=parse_names)
            mask = (batch.pos < end0) & (batch.end_pos >= beg0)
            return subset_batch(batch, mask)
        index = self.index()
        if index is None:
            raise IOError(f"{self.path}: a lazy region fetch needs "
                          f"{self.path}.bai")
        chunks = index.query(ref_id, beg0, end0)
        begs = np.array([c[0] for c in chunks], dtype=np.uint64)
        ends = np.array([c[1] for c in chunks], dtype=np.uint64)
        lib = self._lib
        n = lib.bam_fetch_region(
            self._h, ref_id, beg0, end0,
            begs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ends.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(chunks))
        if n < 0:
            raise IOError(f"{self.path}: native region fetch failed")
        n = int(lib.bam_decode_tags(self._h, ref_id, 1 if parse_tags else 0))
        return self._batch(n, parse_tags, as_views, parse_names)

    def close(self):
        if self._h:
            self._lib.bam_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_bam(path: str, prefer_native: bool = True, lazy: bool = False):
    """The native reader (the default; raises if the library cannot be
    built or the file cannot be opened), or with prefer_native=False the
    pure-Python one. lazy=True opens it for .bai region fetches
    (-WindowSize)."""
    if prefer_native:
        return NativeBamReader(path, lazy=lazy)
    from pisces_tpu_torch.io.bam import BamReader
    return BamReader(path, lazy=lazy)


def native_pileup(reader: NativeBamReader, keep: np.ndarray, min_bq: int,
                  anchor_size: int,
                  anchored_positions: Optional[np.ndarray] = None,
                  ref_codes: Optional[np.ndarray] = None,
                  track_open_ended: bool = True,
                  block_size: int = REGION_SIZE,
                  base_dirs: Optional[np.ndarray] = None):
    """Run the C++ pileup pass, in blocks of block_size positions, over the
    reader's last fetched batch (`keep` is its read mask): the
    read events, their count and quality-error (f64) scatter, and, given
    ref_codes, the per-position scoring tuples, their dedup to unique gVCF
    tuples, and the SNV mismatch events. Returns (PileupCounts, mismatches)
    where mismatches is None without ref_codes, else (gpos, alt, dir, flags)
    for SNV candidate aggregation. `base_dirs` (int8, one code a base of the
    batch, pileup/directions.batch_base_directions) gives stitched (XD)
    reads their per-base directions; without it each base takes its read's
    strand.

    The dense tensors, tuples and mismatches are views into the handle's
    buffers (tens of MB at panel depth): consume them before the handle's
    next fetch or pileup. The gVCF positions are copied, since the
    reference lines keep them until they are written."""
    global pileup_calls
    from pisces_tpu_torch.pileup.counts import PileupCounts
    from pisces_tpu_torch.domain.types import (
        NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, num_anchor_indexes,
    )
    if reader._n_decoded is None or len(keep) != reader._n_decoded:
        raise ValueError(f"keep has {len(keep)} entries; the reader's last "
                         f"fetch decoded {reader._n_decoded} reads")
    lib = reader._lib
    with _count_lock:
        pileup_calls += 1
    h = reader._h
    keep_u8 = np.ascontiguousarray(keep, dtype=np.uint8)
    if anchored_positions is None or len(anchored_positions) == 0:
        ap = np.empty(0, dtype=np.int64)
    else:
        ap = np.unique(np.asarray(anchored_positions, dtype=np.int64))
    rc = (np.ascontiguousarray(ref_codes, dtype=np.int8)
          if ref_codes is not None else None)
    if base_dirs is not None:
        base_dirs = np.ascontiguousarray(base_dirs, dtype=np.int8)
        if len(base_dirs) != int(lib.bam_total_bases(h)):
            raise ValueError(f"base_dirs has {len(base_dirs)} entries; the "
                             f"reader's last fetch decoded "
                             f"{int(lib.bam_total_bases(h))} bases")
    nb = lib.bam_pileup_mm(
        h, keep_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        min_bq, anchor_size, block_size,
        ap.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(ap),
        (base_dirs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
         if base_dirs is not None else None),
        (rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
         if rc is not None else None),
        0 if rc is None else len(rc), 1 if track_open_ended else 0)
    k = num_anchor_indexes(anchor_size)
    shape_t = (nb, block_size, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES)
    block_keys = _as_array(lib.pileup_block_keys(h), nb, np.int64)
    n_t = nb * block_size * NUM_ALLELE_TYPES * NUM_DIRECTION_TYPES
    counts_t = _as_view(lib.pileup_counts_t(h), n_t, np.int32).reshape(shape_t)
    qual_t = _as_view(lib.pileup_qual_t(h), n_t, np.float64).reshape(shape_t)
    shape_a = (len(ap), NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k)
    n_a = int(np.prod(shape_a))
    ac = _as_array(lib.pileup_anchored_counts(h), n_a, np.int32)\
        .reshape(shape_a)
    aq = _as_array(lib.pileup_anchored_quals(h), n_a, np.float64)\
        .reshape(shape_a)
    pc = PileupCounts(block_keys, block_size, anchor_size, counts_t, qual_t,
                      ap, ac, aq)
    if rc is None:
        return pc, None
    if lib.pileup_has_pos_tuples(h):
        pc.pos_tuples = _as_view(lib.pileup_pos_tuples(h),
                                 nb * block_size * 8,
                                 np.int32).reshape(nb * block_size, 8)
        # the C++ dedup of covered in-reference loci to unique scoring
        # tuples, in first-occurrence order (fast_gvcf skips its np.unique)
        # (never -1 here: that means no tuples)
        n_sel = lib.pileup_gvcf_unique(h, block_size, len(rc))
        u = int(lib.pileup_n_uniq(h))
        pc.gvcf_unique = (
            _as_array(lib.pileup_sel_positions(h), n_sel, np.int64),
            _as_view(lib.pileup_uniq_tuples(h), u * 6,
                     np.int32).reshape(u, 6).astype(np.int64),
            _as_view(lib.pileup_uniq_inv(h), n_sel, np.int32))
    n_mm = int(lib.pileup_n_mismatches(h))
    mismatches = (_as_view(lib.pileup_mm_gpos(h), n_mm, np.int64),
                  _as_view(lib.pileup_mm_alt(h), n_mm, np.int8),
                  _as_view(lib.pileup_mm_dir(h), n_mm, np.int8),
                  _as_view(lib.pileup_mm_flags(h), n_mm, np.int8))
    return pc, mismatches


class _RenderedBlobOwner:
    """Owns a render_ref_lines result: exposes the blob as a zero-copy
    memoryview and frees the native buffer when the last Python reference
    (every RefLineBlock slice sharing it included) is dropped."""

    __slots__ = ("_lib", "_h", "mv", "off")

    def __init__(self, lib, h, n: int):
        self._lib = lib
        self._h = h
        blob_len = lib.rl_blob_len(h)
        buf = (ctypes.c_char * blob_len).from_address(lib.rl_blob(h))
        self.mv = memoryview(buf).cast("B")
        self.off = _as_array(lib.rl_line_off(h), n + 1, np.int64)

    def __del__(self):
        try:
            self.mv.release()
        except BufferError:
            # a sub-view of the blob still lives: freeing the buffer now
            # would leave it dangling, so leak it instead (RefLineBlock
            # always holds the owner, so in-repo consumers never get here)
            return
        except Exception:
            pass
        self._lib.rl_free(self._h)


def render_reference_lines(prefix: str, positions: np.ndarray,
                           inv: np.ndarray, bases: np.ndarray, tails: list):
    """C++ rendering of per-locus gVCF reference lines
    "<prefix><pos>\\t.\\t<base><tails[inv]>\\n": returns (blob memoryview,
    [n+1] line offsets, owner), zero-copy into the C++ buffer, which lives
    until `owner` is garbage-collected."""
    n = len(positions)
    if len(inv) != n or len(bases) != n:
        raise ValueError("positions, inv and bases must have one entry a line")
    if n and (int(np.min(inv)) < 0 or int(np.max(inv)) >= len(tails)):
        raise ValueError(f"inv must index the {len(tails)} tails")
    lib = get_lib()
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    inv_c = np.ascontiguousarray(inv, dtype=np.int32)
    bases_c = np.ascontiguousarray(bases, dtype=np.uint8)
    tail_bytes = [t.encode("latin-1") for t in tails]
    tail_off = np.zeros(len(tails) + 1, np.int64)
    np.cumsum([len(t) for t in tail_bytes], out=tail_off[1:])
    p = prefix.encode("latin-1")
    h = lib.render_ref_lines(
        p, len(p), n, pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        inv_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bases_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b"".join(tail_bytes),
        tail_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    owner = _RenderedBlobOwner(lib, h, n)
    return owner.mv, owner.off, owner


def bgzf_compress_parallel(data, level: int = 6, n_threads: int = 0):
    """Deflate a byte buffer into BGZF across C++ threads (the reference's
    BamWriterMultithreaded): fixed 0xFF00-byte chunks, then the EOF block,
    as io/bgzf.compress_with_offsets cuts them. Returns (compressed bytes,
    int64 file offset of each block and of the EOF block): a byte at
    uncompressed offset u has the virtual offset
    (offsets[u // 0xFF00] << 16) | (u % 0xFF00). n_threads 0 takes the
    CPU count (at most 16); raises RuntimeError if zlib fails."""
    lib = get_lib()
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    buf = np.frombuffer(data, dtype=np.uint8)
    h = lib.bgzf_compress(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          len(buf), level, n_threads)
    if not h:
        raise RuntimeError("bgzf_compress failed")
    try:
        nb = lib.bgzfc_n_blocks(h)
        out = ctypes.string_at(lib.bgzfc_data(h), lib.bgzfc_data_len(h))
        offs = _as_array(lib.bgzfc_block_off(h), nb + 1, np.int64)
    finally:
        lib.bgzfc_free(h)
    return out, offs
