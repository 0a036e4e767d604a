"""Text nodes (counterpart of ``keystone_tpu/ops/nlp.py`` § Trimmer,
LowerCase, Tokenizer, NGramsFeaturizer, log_tf, TermFrequency,
CommonSparseFeatures(Model), stable_term_hash, HashingTF, NGramsCounts,
NGramIndexer, StupidBackoffLM; reference src/main/scala/nodes/nlp/ and
nodes/misc/).

Strings are host objects: these nodes run on the host and hand rows to
the device at the CommonSparseFeatures / HashingTF boundary, dense rows
as tensors on the data's device or, with ``sparse_output``, scipy CSR
rows that the sparse solvers and scorers (``ops/sparse.py``) gather from.
Where a dataset carries a chain the native path takes
(``ops/nlp_native.py``), the featurizers re-run the whole chain from the
raw documents in C++; the reference fans its Python maps over a process
pool (``utils/hostmap.py``), the port maps them in turn.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.estimator import Estimator
from keystone_tpu_torch.workflow.transformer import Transformer


class Trimmer(Transformer):
    """Strip leading and trailing whitespace (nodes/nlp/Trim)."""

    is_host = True

    def params(self):
        return ()

    def apply_one(self, s: str) -> str:
        return s.strip()


class LowerCase(Transformer):
    is_host = True

    def params(self):
        return ()

    def apply_one(self, s: str) -> str:
        return s.lower()


class Tokenizer(Transformer):
    """Regex tokenization (nodes/nlp/Tokenizer.scala): split on
    ``pattern``, empty tokens dropped."""

    is_host = True

    def __init__(self, pattern: str = r"[^a-zA-Z0-9']+"):
        super().__init__()
        self.pattern = pattern
        self._re = re.compile(pattern)

    def params(self):
        return (self.pattern,)

    def apply_one(self, s: str) -> List[str]:
        return [t for t in self._re.split(s) if t]


class NGramsFeaturizer(Transformer):
    """tokens → all n-grams for n in ``orders`` (nodes/nlp/NGramsFeaturizer.scala)."""

    is_host = True

    def __init__(self, orders: Sequence[int] = (1, 2)):
        super().__init__()
        self.orders = tuple(int(n) for n in orders)

    def params(self):
        return (self.orders,)

    def apply_one(self, tokens: List[str]) -> List[Tuple[str, ...]]:
        out: List[Tuple[str, ...]] = []
        for n in self.orders:
            if n == 1:
                out.extend((t,) for t in tokens)
            else:
                out.extend(zip(*(tokens[i:] for i in range(n))))
        return out


def log_tf(v: float) -> float:
    """log(1 + count), the text pipelines' tf weighting; a module-level
    function, so that fitted pipelines holding it pickle."""
    import math

    return math.log(v + 1.0)


class TermFrequency(Transformer):
    """n-gram list → {ngram: weighted count} (nodes/misc/TermFrequency.scala)."""

    is_host = True

    def __init__(self, fn: Optional[Callable[[float], float]] = None):
        super().__init__()
        self.fn = fn

    def params(self):
        return None if self.fn is not None else ("identity",)

    def apply_one(self, ngrams: List) -> Dict:
        counts = Counter(ngrams)
        if self.fn is None:
            return dict(counts)
        return {k: self.fn(float(v)) for k, v in counts.items()}


def _native_chain(ds):
    """(config, base dataset) when ``ds`` carries a host chain the native
    path takes, else None (no chain, or one ``chain_config`` refuses)."""
    from keystone_tpu_torch.ops import nlp_native

    chain = getattr(ds, "_host_chain", None)
    if chain is None:
        return None
    cfg = nlp_native.chain_config(chain[1])
    if cfg is None:
        return None
    return cfg, chain[0]


def _base_docs(base) -> Optional[list]:
    """The raw documents of an in-memory host base dataset, or None when
    any item is not a string (then the Python chain runs)."""
    if not base.is_host:
        return None
    docs = base.items
    if docs and not all(isinstance(d, str) for d in docs):
        return None
    return docs


class _RowFeaturizer(Transformer):
    """The last host stage of the text chain: term dicts → rows of
    ``num_features`` columns, dense (a tensor on the data's device) or,
    with ``sparse_output``, scipy CSR rows.  Where the dataset carries a
    chain the native path takes, the rows come from the raw documents
    through ``_native_rows``; otherwise item by item (``apply_one``)."""

    is_host = True
    fusable = False
    sparse_output = False

    def _native_rows(self, docs, cfg):
        raise NotImplementedError

    def apply_dataset(self, ds: Dataset) -> Dataset:
        nc = _native_chain(ds) if ds.is_host else None
        if isinstance(ds, StreamDataset) and ds.is_host:
            if nc is not None:  # sparse rows a host stream, dense rows a device stream
                cfg, base = nc

                def fn(batch, _mask):
                    if batch and not isinstance(batch[0], str):
                        raise TypeError("native text path expects raw doc strings")
                    return self._native_rows(batch, cfg)

                return base.map_batches(fn, host=self.sparse_output)
            if self.sparse_output:
                return Transformer.apply_dataset(self, ds)
            return ds.map_batches(lambda batch, _m: np.stack([self.apply_one(x) for x in batch]), host=False)
        docs = None if nc is None else _base_docs(nc[1])
        if docs is not None:
            rows = self._native_rows(docs, nc[0])
        else:
            rows = [self.apply_one(x) for x in ds.items]
        if self.sparse_output:
            return ds.with_items(rows)
        return Dataset(rows if isinstance(rows, np.ndarray) else np.stack(rows), device=ds.device)


class CommonSparseFeaturesModel(_RowFeaturizer):
    """Term dict → row over the learned vocabulary; ``sparse_output`` emits
    scipy CSR rows (the reference's SparseVector), which the sparse
    solvers and scorers take without densifying."""

    def __init__(self, vocab: Dict, num_features: int, sparse_output: bool = False):
        super().__init__()
        self.vocab = vocab
        self.num_features = int(num_features)
        self.sparse_output = bool(sparse_output)

    def apply_one(self, term_dict: Dict):
        if self.sparse_output:
            cols, vals = [], []
            for term, val in term_dict.items():
                idx = self.vocab.get(term)
                if idx is not None:
                    cols.append(idx)
                    vals.append(val)
            return _csr_row(cols, vals, self.num_features)
        row = np.zeros((self.num_features,), np.float32)
        for term, val in term_dict.items():
            idx = self.vocab.get(term)
            if idx is not None:
                row[idx] = val
        return row

    def __getstate__(self):
        # the packed vocabulary is a cache of the vocabulary: not saved
        state = self.__dict__.copy()
        state.pop("_native_vocab", None)
        return state

    def _native_rows(self, docs, cfg):
        from keystone_tpu_torch.ops import nlp_native

        if "_native_vocab" not in self.__dict__:
            self._native_vocab = nlp_native.pack_vocab(self.vocab)
        blob, offs, vsize = self._native_vocab
        return nlp_native.featurize_docs(docs, blob, offs, vsize, cfg, self.num_features, self.sparse_output)


class CommonSparseFeatures(Estimator):
    """Vocabulary = the top ``num_features`` terms by document frequency
    (nodes/misc/CommonSparseFeatures.scala); ``sparse_output=True`` keeps
    CSR rows, so that the optimizer's node choice picks the sparse solvers."""

    def __init__(self, num_features: int, sparse_output: bool = False):
        self.num_features = int(num_features)
        self.sparse_output = bool(sparse_output)

    def params(self):
        return (self.num_features, self.sparse_output)

    def fit_dataset(self, data: Dataset) -> CommonSparseFeaturesModel:
        if isinstance(data, StreamDataset) and data.is_host:
            native = self._fit_native_stream(data)
            if native is not None:
                return native
            # one sweep with Counter-sized state: the raw corpus never materializes
            return self.fit_arrays(d for batch in data.batches() for d in batch)
        if data.is_host:
            native = self._fit_native_items(data)
            if native is not None:
                return native
        return self.fit_arrays(data.items)

    def _fit_native_stream(self, data) -> Optional[CommonSparseFeaturesModel]:
        """The native df sweep over the raw document stream."""
        from keystone_tpu_torch.ops import nlp_native

        nc = _native_chain(data)
        if nc is None:
            return None
        cfg, base = nc
        acc = nlp_native.DfAccumulator(cfg)
        try:
            for batch in base.batches():
                if batch and not isinstance(batch[0], str):
                    return None  # the base stream is not raw text
                acc.update(batch)
            top = acc.topn(self.num_features)
        finally:
            acc.close()
        return self._model({t: i for i, (t, _) in enumerate(top)})

    def _fit_native_items(self, data) -> Optional[CommonSparseFeaturesModel]:
        """The in-memory twin, in batches of 8192 documents."""
        from keystone_tpu_torch.ops import nlp_native

        nc = _native_chain(data)
        if nc is None:
            return None
        cfg, base = nc
        docs = _base_docs(base)
        if docs is None:
            return None
        acc = nlp_native.DfAccumulator(cfg)
        try:
            for i in range(0, len(docs), 8192):
                acc.update(docs[i:i + 8192])
            top = acc.topn(self.num_features)
        finally:
            acc.close()
        return self._model({t: i for i, (t, _) in enumerate(top)})

    def fit_arrays(self, docs: Iterable[Dict]) -> CommonSparseFeaturesModel:
        df: Counter = Counter()
        for d in docs:
            df.update(set(d.keys()))
        return self._model({t: i for i, (t, _) in enumerate(df.most_common(self.num_features))})

    def _model(self, vocab: Dict) -> CommonSparseFeaturesModel:
        return CommonSparseFeaturesModel(vocab, self.num_features, self.sparse_output)


def _csr_row(cols, vals, num_features: int):
    """One CSR row from its columns and values, the columns checked
    against ``num_features`` (the direct constructor checks no bound)."""
    import scipy.sparse as sp

    idx = np.asarray(cols, np.int32)
    if idx.size and (int(idx.max()) >= num_features or int(idx.min()) < 0):
        raise ValueError(f"column index out of bounds for {num_features} features "
                         f"(got {int(idx.max())}/{int(idx.min())})")
    return sp.csr_matrix((np.asarray(vals, np.float32), idx, np.array([0, len(cols)], np.int32)),
                         shape=(1, num_features), copy=False)


#: term → hash memo, capped (the corpus's terms are Zipfian, so the head
#: stays resident; past the cap new terms hash uncached)
_TERM_HASH_MEMO: Dict = {}
_TERM_HASH_MEMO_CAP = 1 << 17


def stable_term_hash(term) -> int:
    """A process-independent term hash: blake2b-8 of the term's repr,
    little-endian (Python's ``hash(str)`` is salted per process, which
    would scramble HashingTF's features across a save and load)."""
    h = _TERM_HASH_MEMO.get(term)
    if h is None:
        import hashlib

        h = int.from_bytes(hashlib.blake2b(repr(term).encode(), digest_size=8).digest(), "little")
        if len(_TERM_HASH_MEMO) < _TERM_HASH_MEMO_CAP:
            _TERM_HASH_MEMO[term] = h
    return h


class HashingTF(_RowFeaturizer):
    """Feature hashing to ``num_features`` columns (no fitted vocabulary;
    Spark's HashingTF's role), the tf values of colliding terms summed."""

    def __init__(self, num_features: int = 2**16, sparse_output: bool = False):
        super().__init__()
        if num_features > (1 << 31) - 1:
            # the native chain's columns are int32; the reference's Python
            # chain takes wider, which no pipeline uses
            raise ValueError(f"HashingTF takes at most 2^31 - 1 features, not {num_features}")
        self.num_features = int(num_features)
        self.sparse_output = bool(sparse_output)

    def params(self):
        return (self.num_features, self.sparse_output)

    def apply_one(self, term_dict: Dict):
        if self.sparse_output:
            acc: Dict[int, float] = defaultdict(float)
            for term, val in term_dict.items():
                acc[stable_term_hash(term) % self.num_features] += float(val)
            return _csr_row(list(acc.keys()), list(acc.values()), self.num_features)
        row = np.zeros((self.num_features,), np.float32)
        for term, val in term_dict.items():
            row[stable_term_hash(term) % self.num_features] += val
        return row

    def _native_rows(self, docs, cfg):
        from keystone_tpu_torch.ops import nlp_native

        return nlp_native.hashtf_docs(docs, cfg, self.num_features, self.sparse_output)


class NGramsCounts(Transformer):
    """Corpus-level n-gram counts (nodes/nlp/NGramsCounts.scala): a dataset
    of n-gram lists → one Counter, a host reduction."""

    is_host = True
    fusable = False

    def params(self):
        return ()

    def apply_dataset(self, ds: Dataset) -> Dataset:
        total: Counter = Counter()
        for ngrams in ds.items:
            total.update(ngrams)
        return ds.with_items([total])

    def apply_one(self, ngrams):
        return Counter(ngrams)


class NGramIndexer:
    """Packs n-grams of word ids into one int64 key
    (nodes/nlp/NGramIndexer.scala): ``bits`` a word id (21: a 3-gram fits
    one int64, vocabulary ≤ 2M), id 0 reserved for an empty slot."""

    def __init__(self, bits: int = 21):
        self.bits = int(bits)
        self._vocab: Dict[str, int] = {}
        self._reverse: Dict[int, str] = {}

    def word_id(self, word: str) -> int:
        idx = self._vocab.get(word)
        if idx is None:
            idx = len(self._vocab) + 1
            if idx >= (1 << self.bits):
                raise OverflowError(f"vocabulary exceeds 2^{self.bits} words")
            self._vocab[word] = idx
            self._reverse[idx] = word
        return idx

    def pack(self, ngram: Sequence[str]) -> int:
        if len(ngram) * self.bits > 63:
            raise OverflowError(f"{len(ngram)}-gram at {self.bits} bits/word")
        key = 0
        for w in ngram:
            key = (key << self.bits) | self.word_id(w)
        return key

    def unpack(self, key: int, order: int) -> tuple:
        words = []
        for _ in range(order):
            words.append(self._reverse.get(key & ((1 << self.bits) - 1), "<unk>"))
            key >>= self.bits
        return tuple(reversed(words))


class StupidBackoffLM(Transformer):
    """Stupid-backoff n-gram scorer (nodes/nlp/StupidBackoff.scala):
    S(w | context) = count(ngram)/count(context) if seen, else
    α·S(w | shorter context), down to the unigram frequency; α = 0.4
    (Brants et al. 2007)."""

    is_host = True
    fusable = False

    def __init__(self, counts: Dict[Tuple[str, ...], int], alpha: float = 0.4):
        super().__init__()
        self.counts = dict(counts)
        self.alpha = float(alpha)
        self.total_unigrams = sum(v for k, v in self.counts.items() if len(k) == 1)
        context: Dict[Tuple[str, ...], int] = defaultdict(int)
        for k, v in self.counts.items():
            if len(k) >= 2:
                context[k[:-1]] += v
        self._context = context

    def params(self):
        return None

    def score(self, ngram: Tuple[str, ...]) -> float:
        ngram = tuple(ngram)
        if len(ngram) == 1:
            if self.total_unigrams == 0:
                return 0.0
            return self.counts.get(ngram, 0) / self.total_unigrams
        c = self.counts.get(ngram, 0)
        ctx = self._context.get(ngram[:-1], 0)
        if c > 0 and ctx > 0:
            return c / ctx
        return self.alpha * self.score(ngram[1:])

    def apply_one(self, ngram):
        return self.score(tuple(ngram))
