"""Deployment export: the eval forward as TensorFlow ops (``tf_graph``), the
TFLite and SavedModel files and their runner (``tflite``). TensorFlow is
imported inside the functions."""
