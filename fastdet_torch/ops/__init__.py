"""Serving-path ops of the port: decode, NMS and postprocess."""
