"""Configurations of the port: the paper's own GBDT workload (`xgb_paper`)."""
