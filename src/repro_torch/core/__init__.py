"""Core numerics: encoding, neurons, layers, conversion, engine."""
