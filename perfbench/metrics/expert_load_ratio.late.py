"""How unevenly the router loads the experts: in each MoE layer the busiest
expert's routed rows over the mean, averaged over the MoE layers and the
profiled rounds (the model's device counts, read once a round after its
barrier; 1 is an even load)."""


def read(run):
    loads = [r["expert_loads"] for r in run.profiled if r.get("expert_loads") is not None]
    ratios = [row.max() / row.mean() for layer_loads in loads for row in layer_loads if row.sum() > 0]
    return sum(ratios) / len(ratios) if ratios else None
