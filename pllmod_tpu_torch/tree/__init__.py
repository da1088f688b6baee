"""Tree topology, Newick IO and traversal compilation."""
