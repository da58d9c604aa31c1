"""The paper's workloads (counterpart of ``repro.configs.paper_logreg``)."""
