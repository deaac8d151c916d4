"""The plain reference the checks judge the program by: exact k-NN in
float64, squared distances worked out again, PQ codes encoded again from a
codebook, and the structure of a graph.  Plain PyTorch; it imports nothing
of the program and takes nothing the program made except what it judges."""
