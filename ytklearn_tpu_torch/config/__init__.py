"""HOCON configs, typed GBDT params and the YTK_* knob registry of the port."""
