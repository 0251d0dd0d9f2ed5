"""Model code of the port: layers, GQA attention, the layer stack, the LM."""
