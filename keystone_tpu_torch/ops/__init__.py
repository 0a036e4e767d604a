"""Feature ops (counterpart of ``keystone_tpu/ops/__init__.py``): the
reference's exports under the same names, each imported from its module
on first use, so that importing one op module does not import them all."""

import importlib

_EXPORTS = {
    **dict.fromkeys(("ColumnSampler", "CosineRandomFeatures", "LinearRectifier", "NormalizeRows", "PaddedFFT",
                     "RandomSignNode", "Sampler", "SignedHellingerMapper", "StandardScaler", "StandardScalerModel"),
                    "stats"),
    **dict.fromkeys(("BucketedSparseRows", "PaddedSparseRows"), "sparse"),
    **dict.fromkeys(("ClassLabelIndicators", "Densify", "FloatToDouble", "MaxClassifier", "Sparsify",
                     "TopKClassifier", "VectorCombiner", "VectorSplitter"), "util"),
    **dict.fromkeys(("CenterCornerPatcher", "Convolver", "GrayScaler", "ImageVectorizer", "PixelScaler", "Pooler",
                     "RandomPatcher", "SymmetricRectifier", "Windower"), "images"),
    "SIFTExtractor": "sift",
    "LCSExtractor": "lcs",
    "DaisyExtractor": "daisy",
    **dict.fromkeys(("FisherVector", "FusedPcaFisherVector", "GMMFisherVectorEstimator"), "fisher"),
    **dict.fromkeys(("CommonSparseFeatures", "HashingTF", "LowerCase", "NGramsCounts", "NGramsFeaturizer",
                     "StupidBackoffLM", "TermFrequency", "log_tf", "Tokenizer", "Trimmer"), "nlp"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
