"""The train step and its optimizer (port of ``repro.train``)."""
