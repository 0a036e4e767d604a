"""Host text stage throughput: the Python per-document chain against the
native chain (``ops/nlp_native.py`` over ``csrc/text.cpp``), on the
synthetic corpus of the repo's ``tools/bench_text.py`` (120 tokens a
document, a 5k-word Zipf vocabulary).

    python -m keystone_tpu_torch.tools.bench_text [n_docs] [--python-docs M] [--device cpu] [--json]

Measures docs/s of the streaming two-pass fit (the document-frequency
sweep, then the featurize sweep) and of the hashing pass, for both
chains through the same ``StreamDataset`` chain (Trimmer → LowerCase →
Tokenizer → 1,2-grams → log tf → CommonSparseFeatures or HashingTF, CSR
rows).  The Python chain maps its large batches over ``host_map``'s
worker pool (``KEYSTONE_HOST_WORKERS`` wide, or the process's pool where
one runs; the report names its size); the native one threads over the
documents in C++.  A first pass through each chain, untimed, loads the
library and starts the pool.  The work is the host's: ``--device`` only says where
a dense row would go (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

VOCAB = 5000
TOKENS_PER_DOC = 120
BATCH = 2048
NUM_FEATURES = 1 << 15
WARM_DOCS = 512


def corpus(n: int):
    rng = np.random.default_rng(0)
    words = np.array([f"w{i}" for i in range(VOCAB)])
    probs = 1.0 / np.arange(1, VOCAB + 1) ** 1.1
    probs /= probs.sum()
    return [" ".join(words[rng.choice(VOCAB, TOKENS_PER_DOC, p=probs)]) for _ in range(n)]


def _terms(docs, use_native: bool, device):
    """The host stream of term dicts, with (native) or without (Python)
    the chain the native path reads."""
    from keystone_tpu_torch.ops.nlp import LowerCase, NGramsFeaturizer, TermFrequency, Tokenizer, Trimmer, log_tf
    from keystone_tpu_torch.workflow.dataset import StreamDataset

    def src():
        for i in range(0, len(docs), BATCH):
            yield docs[i:i + BATCH]

    out = StreamDataset(src, n=len(docs), host=True, device=device)
    for t in (Trimmer(), LowerCase(), Tokenizer(), NGramsFeaturizer((1, 2)), TermFrequency(log_tf)):
        out = t.apply_dataset(out)
    if not use_native:
        out._host_chain = None  # the Python path
    return out


def run_two_pass(docs, use_native: bool, device="cuda") -> dict:
    from keystone_tpu_torch.ops.nlp import CommonSparseFeatures

    out = _terms(docs, use_native, device)
    t0 = time.perf_counter()
    model = CommonSparseFeatures(NUM_FEATURES, sparse_output=True).fit_dataset(out)
    t_df = time.perf_counter() - t0
    feat = model.apply_dataset(out)
    t1 = time.perf_counter()
    nrows = sum(len(b) for b in feat.batches())
    t_feat = time.perf_counter() - t1
    if nrows != len(docs):
        raise RuntimeError(f"featurized {nrows} rows of {len(docs)} documents")
    n = len(docs)
    return {"docs": n, "df_docs_per_s": n / t_df, "featurize_docs_per_s": n / t_feat,
            "two_pass_docs_per_s": n / (t_df + t_feat)}


def run_hash_pass(docs, use_native: bool, device="cuda") -> dict:
    from keystone_tpu_torch.ops.nlp import HashingTF

    feat = HashingTF(NUM_FEATURES, sparse_output=True).apply_dataset(_terms(docs, use_native, device))
    t0 = time.perf_counter()
    nrows = sum(len(b) for b in feat.batches())
    dt = time.perf_counter() - t0
    if nrows != len(docs):
        raise RuntimeError(f"hashed {nrows} rows of {len(docs)} documents")
    return {"docs": len(docs), "docs_per_s": len(docs) / dt}


def run(n: int = 100_000, python_docs: int = 0, device="cuda") -> dict:
    """Both chains' docs/s on an ``n``-document corpus, the Python chain
    on its first ``python_docs`` (default all)."""
    from keystone_tpu_torch.ops import nlp_native
    from keystone_tpu_torch.utils.device import resolve_device
    from keystone_tpu_torch.utils.hostmap import pool_workers

    dev = resolve_device(device)
    if not nlp_native.available():
        raise RuntimeError("the native text library did not build: no native chain to measure")
    docs = corpus(n)
    py_docs = docs[:python_docs or n]
    # untimed: loads the native library, starts the worker pool (512
    # documents, host_map's least, reach every worker)
    run_two_pass(docs[:BATCH], True, dev)
    run_two_pass(docs[:WARM_DOCS], False, dev)
    native, python = run_two_pass(docs, True, dev), run_two_pass(py_docs, False, dev)
    hn, hp = run_hash_pass(docs, True, dev), run_hash_pass(py_docs, False, dev)
    return {"corpus": {"docs": n, "tokens_per_doc": TOKENS_PER_DOC, "vocab": VOCAB},
            # the process's one pool, as a caller may have sized it (1: none;
            # a batch under host_map's 512 items maps in turn all the same)
            "host_workers": pool_workers() or 1, "native": native, "python": python,
            "two_pass_speedup": native["two_pass_docs_per_s"] / python["two_pass_docs_per_s"],
            "hash_native": hn, "hash_python": hp, "hash_speedup": hn["docs_per_s"] / hp["docs_per_s"]}


def render(r: dict) -> str:
    c = r["corpus"]
    lines = [f"corpus: {c['docs']} docs x {c['tokens_per_doc']} tokens, vocab {c['vocab']}; "
             f"host_map workers {r['host_workers']}"]
    for name in ("native", "python"):
        p = r[name]
        lines.append(f"  {name}: df {p['df_docs_per_s']:8.0f} docs/s   featurize {p['featurize_docs_per_s']:8.0f} "
                     f"docs/s   2-pass {p['two_pass_docs_per_s']:8.0f} docs/s ({p['docs']} docs)")
    lines.append(f"speedup (2-pass docs/s): {r['two_pass_speedup']:.2f}x")
    for name in ("hash_native", "hash_python"):
        lines.append(f"  {name}: {r[name]['docs_per_s']:8.0f} docs/s ({r[name]['docs']} docs)")
    lines.append(f"speedup (hashtf docs/s): {r['hash_speedup']:.2f}x")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="host text chain docs/s: Python against native")
    ap.add_argument("n_docs", nargs="?", type=int, default=100_000)
    ap.add_argument("--python-docs", type=int, default=0, help="documents for the Python chain (default all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", help="print the result as one JSON object")
    args = ap.parse_args(argv)
    r = run(args.n_docs, args.python_docs, args.device)
    print(json.dumps(r) if args.json else render(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
