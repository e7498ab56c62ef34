"""The SiHGNN system of the port: CTT planner, SGB, Graph Restructurer and
the HGNN models (``repro_torch.core.hgnn``)."""
