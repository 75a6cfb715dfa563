"""Core of the port: quantisation, objectives, splits, histogram store, tree
builders (in-core and over streamed pages), byte model, execution policy and
the `GradientBooster` estimator."""
