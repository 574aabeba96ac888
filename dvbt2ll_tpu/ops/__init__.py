"""Alternative formulations of hot ops, kept beside the pipeline."""
