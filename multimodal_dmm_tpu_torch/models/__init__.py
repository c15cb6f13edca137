"""Models: the NN core, codecs and MultiDMM."""
