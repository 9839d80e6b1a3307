"""Model layer: data containers and the GNMGP parameter layout and Gram."""
