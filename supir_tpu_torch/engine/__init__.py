"""SUPIREngine and its factory."""
