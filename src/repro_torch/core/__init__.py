"""Core of the port: quantisation, objectives, splits, histogram store, tree
builder, byte model, execution policy and the `GradientBooster` estimator."""
