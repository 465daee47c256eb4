"""Formula compiler and covariance library."""
