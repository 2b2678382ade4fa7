from repro_torch.rdf.vocab import lubm_ontology
from repro_torch.rdf.generator import generate_lubm, generate_deep_ontology, RawDataset
