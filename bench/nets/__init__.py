"""The harness's side of each configuration: weights and inputs drawn from
the seed on the device, in the layout the program takes and the
references read."""
