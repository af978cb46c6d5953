"""Star detection on fixed-capacity candidate arrays."""
