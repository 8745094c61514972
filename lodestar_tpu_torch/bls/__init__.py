"""BLS signature-set verification on the port's device engine."""
