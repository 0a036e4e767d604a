"""Static analysis of workflow graphs (counterpart of ``keystone_tpu/analysis``).

Only the signature-collision admission gate of the cross-pipeline
sharing plan is ported (:mod:`~keystone_tpu_torch.analysis.signatures`);
the findings passes and the analyzer are ROADMAP A10's.
"""
