"""Post-processing: port spectra, near-to-far-field transform, Touchstone."""
