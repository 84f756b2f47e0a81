"""Loss logging, plots and run logs."""
