"""Roofline cost model of the port (the device-independent part of
``repro.roofline``), on the NVIDIA H100 SXM5's published peaks."""
