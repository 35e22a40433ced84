"""Model definitions in the conversion format."""
