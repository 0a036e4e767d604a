"""The native host text chain (counterpart of
``keystone_tpu/ops/nlp_native.py`` § chain_config, featurize_docs,
hashtf_docs, pack_vocab, DfAccumulator).

The fused trim → lower → tokenize → n-gram → tf → {vocabulary CSR |
hashed CSR | df} chain runs in ``csrc/text.cpp``, the port's copy of the
reference's ``ks_text_*`` functions, built with ``g++`` at first use
(``kernels/build.py``) and called through ``ctypes`` with the GIL
released and a thread pool over the documents.

Host datasets and streams carry their provenance (``_host_chain``: the
base raw-document dataset and the host transformers applied since, set by
``Transformer.apply_dataset``), and ``ops/nlp.py``'s featurizers hand the
raw documents to this chain when ``chain_config`` accepts the chain.

Unlike the reference there is no fallback: a library that fails to build
or load raises.  The reference drops to its Python chain then, which
orders df ties otherwise (by ``Counter.most_common``'s set iteration, not
(−df, first document, term)) and so picks another vocabulary.  The
Python chain runs only where ``chain_config`` refuses the chain (a
non-default token pattern, a custom tf function).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

#: joined-key separator bridging the C++ term strings and Python token tuples
SEP = "\x1f"

_DEFAULT_TOKEN_PATTERN = r"[^a-zA-Z0-9']+"

_P = ctypes.POINTER


def _lib() -> ctypes.CDLL:
    """The built library, its signatures declared; a failed build raises."""
    from keystone_tpu_torch.kernels import build

    with build.LOCK:
        return _declare(build.load("text"))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    if not getattr(lib, "_ks_declared", False):
        i64, i64p, cp, ci = ctypes.c_int64, _P(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int
        csr_out = (i64p, _P(_P(ctypes.c_int32)), _P(_P(ctypes.c_float)))
        lib.ks_text_featurize.argtypes = (cp, i64p, i64, cp, i64p, i64, ctypes.c_uint32, ci, ci, ci, ci, *csr_out)
        lib.ks_text_hashtf.argtypes = (cp, i64p, i64, ctypes.c_uint32, ci, ci, ci, i64, ci, *csr_out)
        lib.ks_text_df_new.argtypes = (ctypes.c_uint32, ci, ci)
        lib.ks_text_df_update.argtypes = (ctypes.c_void_p, cp, i64p, i64)
        lib.ks_text_df_topn.argtypes = (ctypes.c_void_p, i64, _P(_P(ctypes.c_char)), _P(i64p), _P(i64p), i64p)
        lib.ks_text_df_free.argtypes = (ctypes.c_void_p,)
        lib.ks_free.argtypes = (ctypes.c_void_p,)
        for f in (lib.ks_text_featurize, lib.ks_text_hashtf, lib.ks_text_df_update, lib.ks_text_df_topn):
            f.restype = ci
        lib.ks_text_df_new.restype = ctypes.c_void_p
        lib.ks_text_df_free.restype = None
        lib.ks_free.restype = None
        lib._ks_declared = True
    return lib


def available() -> bool:
    """Whether the native chain can run: it builds (or is built) and
    loads.  It raises where it cannot: there is no other path."""
    _lib()
    return True


def _pack_docs(docs: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    enc = [d.encode("utf-8", "surrogatepass") for d in docs]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offs[1:])
    return b"".join(enc), offs


def chain_config(stages) -> Optional[dict]:
    """A host-transformer chain as a native config, or None if a stage is
    outside the supported pattern: [Trimmer?] [LowerCase?]
    Tokenizer(default pattern) NGramsFeaturizer(distinct orders within
    1..8) TermFrequency(None | log_tf)."""
    from keystone_tpu_torch.ops.nlp import LowerCase, NGramsFeaturizer, TermFrequency, Tokenizer, Trimmer, log_tf

    stages = list(stages)
    trim = lower = False
    while stages and isinstance(stages[0], (Trimmer, LowerCase)):
        if isinstance(stages[0], Trimmer):
            trim = True
        else:
            lower = True
        stages.pop(0)
    if len(stages) != 3:
        return None
    tok, ngrams, tf = stages
    if not isinstance(tok, Tokenizer) or tok.pattern != _DEFAULT_TOKEN_PATTERN:
        return None
    if not isinstance(ngrams, NGramsFeaturizer) or not all(1 <= n <= 8 for n in ngrams.orders):
        return None
    if len(set(ngrams.orders)) != len(ngrams.orders):
        # duplicate orders collapse in the orders mask, where the Python
        # chain counts an n-gram once per duplicate
        return None
    if not isinstance(tf, TermFrequency) or tf.fn not in (None, log_tf):
        return None
    mask = 0
    for n in ngrams.orders:
        mask |= 1 << (n - 1)
    return {"orders_mask": mask, "log_tf": 1 if tf.fn is log_tf else 0, "lower": 1 if lower else 0,
            "trim": 1 if trim else 0}


def _unpack_native_rows(lib, indptr, out_idx, out_val, n, num_features, sparse_output):
    """Copy a ks_text_* CSR result out of native memory (and free it) and
    build the payload: scipy CSR rows, or a dense (n, F) float32 array."""
    import scipy.sparse as sp

    nnz = int(indptr[-1])
    try:
        idx = np.ctypeslib.as_array(out_idx, shape=(max(nnz, 1),))[:nnz].copy()
        val = np.ctypeslib.as_array(out_val, shape=(max(nnz, 1),))[:nnz].copy()
    finally:
        lib.ks_free(ctypes.cast(out_idx, ctypes.c_void_p))
        lib.ks_free(ctypes.cast(out_val, ctypes.c_void_p))
    if sparse_output:
        rows: List = []
        for i in range(n):
            lo, hi = int(indptr[i]), int(indptr[i + 1])
            rows.append(sp.csr_matrix((val[lo:hi], idx[lo:hi], np.array([0, hi - lo], np.int32)),
                                      shape=(1, num_features), copy=False))
        return rows
    dense = np.zeros((n, num_features), np.float32)
    for i in range(n):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        dense[i, idx[lo:hi]] = val[lo:hi]
    return dense


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_P(ctypes.c_int64))


def featurize_docs(docs: Sequence[str], vocab_keys_joined: bytes, vocab_offs: np.ndarray, vsize: int, cfg: dict,
                   num_features: int, sparse_output: bool, threads: int = 0):
    """Raw documents → CSR rows (scipy, one a document) or a dense (n, F)
    array over a packed vocabulary (``pack_vocab``)."""
    lib = _lib()
    blob, offs = _pack_docs(docs)
    n = len(docs)
    indptr = np.zeros(n + 1, np.int64)
    out_idx = _P(ctypes.c_int32)()
    out_val = _P(ctypes.c_float)()
    rc = lib.ks_text_featurize(blob, _i64p(offs), ctypes.c_int64(n), vocab_keys_joined, _i64p(vocab_offs),
                               ctypes.c_int64(vsize), ctypes.c_uint32(cfg["orders_mask"]), cfg["log_tf"],
                               cfg["lower"], cfg["trim"], threads, _i64p(indptr), ctypes.byref(out_idx),
                               ctypes.byref(out_val))
    if rc != 0:
        raise RuntimeError(f"ks_text_featurize failed: {rc}")
    return _unpack_native_rows(lib, indptr, out_idx, out_val, n, num_features, sparse_output)


def hashtf_docs(docs: Sequence[str], cfg: dict, num_features: int, sparse_output: bool, threads: int = 0):
    """Raw documents → HashingTF rows: column = blake2b-8(repr(term)) mod
    ``num_features`` (``stable_term_hash``'s contract), the tf values of
    colliding terms summed."""
    lib = _lib()
    blob, offs = _pack_docs(docs)
    n = len(docs)
    indptr = np.zeros(n + 1, np.int64)
    out_idx = _P(ctypes.c_int32)()
    out_val = _P(ctypes.c_float)()
    rc = lib.ks_text_hashtf(blob, _i64p(offs), ctypes.c_int64(n), ctypes.c_uint32(cfg["orders_mask"]),
                            cfg["log_tf"], cfg["lower"], cfg["trim"], ctypes.c_int64(num_features), threads,
                            _i64p(indptr), ctypes.byref(out_idx), ctypes.byref(out_val))
    if rc != 0:
        raise RuntimeError(f"ks_text_hashtf failed: {rc}")
    return _unpack_native_rows(lib, indptr, out_idx, out_val, n, num_features, sparse_output)


def pack_vocab(vocab: dict) -> Tuple[bytes, np.ndarray, int]:
    """A {token tuple: column} vocabulary → (joined blob, offsets, size),
    in column order, so that the C++ ids are the Python ids."""
    items = sorted(vocab.items(), key=lambda kv: kv[1])
    enc = [SEP.join(t).encode("utf-8", "surrogatepass") for t, _ in items]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offs[1:])
    return b"".join(enc), offs, len(enc)


class DfAccumulator:
    """Streaming document-frequency sweep: feed raw document batches, then
    ``topn`` returns [(token tuple, df)] by (−df, first document, term)."""

    def __init__(self, cfg: dict):
        self._lib = _lib()
        self._h = self._lib.ks_text_df_new(cfg["orders_mask"], cfg["lower"], cfg["trim"])

    def update(self, docs: Sequence[str]) -> None:
        blob, offs = _pack_docs(docs)
        rc = self._lib.ks_text_df_update(self._h, blob, _i64p(offs), len(docs))
        if rc != 0:
            raise RuntimeError(f"ks_text_df_update failed: {rc}")

    def topn(self, n: int) -> List[Tuple[tuple, int]]:
        lib = self._lib
        terms = _P(ctypes.c_char)()
        offs = _P(ctypes.c_int64)()
        counts = _P(ctypes.c_int64)()
        out_n = ctypes.c_int64(0)
        rc = lib.ks_text_df_topn(self._h, ctypes.c_int64(n), ctypes.byref(terms), ctypes.byref(offs),
                                 ctypes.byref(counts), ctypes.byref(out_n))
        if rc != 0:
            raise RuntimeError(f"ks_text_df_topn failed: {rc}")
        try:
            m = out_n.value
            off = np.ctypeslib.as_array(offs, shape=(m + 1,))
            blob = ctypes.string_at(terms, int(off[m])) if m else b""
            cnt = np.ctypeslib.as_array(counts, shape=(max(m, 1),))
            return [(tuple(blob[int(off[i]):int(off[i + 1])].decode("utf-8", "surrogatepass").split(SEP)),
                     int(cnt[i])) for i in range(m)]
        finally:
            for p in (terms, offs, counts):
                lib.ks_free(ctypes.cast(p, ctypes.c_void_p))

    def close(self) -> None:
        if self._h:
            self._lib.ks_text_df_free(self._h)
            self._h = None

    def __del__(self):  # best effort; close() is the contract
        try:
            self.close()
        except Exception:
            pass
