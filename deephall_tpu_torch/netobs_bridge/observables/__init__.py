"""netobs estimator plugins of the port (require the external ``netobs`` package)."""
