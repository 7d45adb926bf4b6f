"""Frozen numpy copies of the host build: surfaces and readers, distance
fields, the octree mesher, point-in-solid tests, face detection, ghost
bands and kNN interpolation stencils.

They are copies, and stay so: the reference rebuilds every mesh table
from the configuration with them, and never takes a table that the code
under test has made. The mesh, and with it the cell order, is a function
of the configuration alone, so the reference's cells are the program's.
"""
