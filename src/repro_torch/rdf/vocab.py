"""The LUBM-style university ontology used throughout the evaluation.

Mirrors the Lehigh University Benchmark ontology [Guo, Pan, Heflin 2005] at
the RDFS level: 43 concepts, 32 properties, 21 domain and 18 range axioms —
the same shape as the paper's Table II row for LUBM.  OWL restrictions that
RDFS cannot express are approximated the way the paper's experiments imply:
e.g. LUBM defines Chair as "Person ⊓ ∃headOf.Department"; we set
``domain(headOf) = Chair`` so that lite materialization derives Chair types
from headOf assertions (which is why, like the paper notes for their Q4, the
raw dataset contains no explicit Chair triples).
"""
from __future__ import annotations

from repro_torch.core.tbox import Ontology

CONCEPTS = [
    # organizations
    "University", "College", "Department", "Institute", "Program",
    "ResearchGroup", "Organization",
    # works & publications
    "Work", "Course", "GraduateCourse", "Research", "Publication", "Article",
    "Book", "ConferencePaper", "JournalArticle", "Manual", "Software",
    "Specification", "TechnicalReport", "UnofficialPublication",
    # people
    "Person", "Employee", "AdministrativeStaff", "ClericalStaff",
    "SystemsStaff", "Faculty", "Lecturer", "PostDoc", "Professor",
    "AssistantProfessor", "AssociateProfessor", "Chair", "Dean",
    "FullProfessor", "VisitingProfessor", "Director", "Student",
    "GraduateStudent", "UndergraduateStudent", "ResearchAssistant",
    "TeachingAssistant",
    # misc
    "Schedule",
]

SUBCLASS = [
    ("University", "Organization"), ("College", "Organization"),
    ("Department", "Organization"), ("Institute", "Organization"),
    ("Program", "Organization"), ("ResearchGroup", "Organization"),
    ("Course", "Work"), ("GraduateCourse", "Course"), ("Research", "Work"),
    ("Article", "Publication"), ("Book", "Publication"),
    ("ConferencePaper", "Article"), ("JournalArticle", "Article"),
    ("TechnicalReport", "Article"), ("Manual", "Publication"),
    ("Software", "Publication"), ("Specification", "Publication"),
    ("UnofficialPublication", "Publication"),
    ("Employee", "Person"), ("AdministrativeStaff", "Employee"),
    ("ClericalStaff", "AdministrativeStaff"),
    ("SystemsStaff", "AdministrativeStaff"), ("Faculty", "Employee"),
    ("Lecturer", "Faculty"), ("PostDoc", "Faculty"),
    ("Professor", "Faculty"), ("AssistantProfessor", "Professor"),
    ("AssociateProfessor", "Professor"), ("Chair", "Professor"),
    ("Dean", "Professor"), ("FullProfessor", "Professor"),
    ("VisitingProfessor", "Professor"), ("Director", "Person"),
    ("Student", "Person"), ("GraduateStudent", "Student"),
    ("UndergraduateStudent", "Student"), ("ResearchAssistant", "Person"),
    ("TeachingAssistant", "Person"),
]

OBJECT_PROPERTIES = [
    "advisor", "affiliatedOrganizationOf", "affiliateOf", "degreeFrom",
    "doctoralDegreeFrom", "mastersDegreeFrom", "undergraduateDegreeFrom",
    "headOf", "worksFor", "memberOf", "member", "orgPublication",
    "publicationAuthor", "publicationResearch", "researchProject",
    "softwareDocumentation", "subOrganizationOf", "takesCourse",
    "teacherOf", "teachingAssistantOf", "hasAlumnus", "listedCourse",
    "publicationDate", "softwareVersion", "tenured",
]
DATATYPE_PROPERTIES = [
    "age", "emailAddress", "name", "officeNumber", "researchInterest",
    "telephone", "title",
]
PROPERTIES = OBJECT_PROPERTIES + DATATYPE_PROPERTIES

SUBPROP = [
    ("doctoralDegreeFrom", "degreeFrom"),
    ("mastersDegreeFrom", "degreeFrom"),
    ("undergraduateDegreeFrom", "degreeFrom"),
    ("headOf", "worksFor"),
    ("worksFor", "memberOf"),
]

DOMAIN = {  # 21 domain axioms
    "advisor": ["Person"],
    "degreeFrom": ["Person"],
    "doctoralDegreeFrom": ["Person"],
    "mastersDegreeFrom": ["Person"],
    "undergraduateDegreeFrom": ["Person"],
    "headOf": ["Chair"],  # RDFS reading of LUBM's Chair restriction
    "worksFor": ["Employee"],
    "memberOf": ["Person"],
    "member": ["Organization"],
    "orgPublication": ["Organization"],
    "publicationAuthor": ["Publication"],
    "publicationResearch": ["Publication"],
    "researchProject": ["ResearchGroup"],
    "softwareDocumentation": ["Software"],
    "subOrganizationOf": ["Organization"],
    "takesCourse": ["Student"],
    "teacherOf": ["Faculty"],
    "teachingAssistantOf": ["TeachingAssistant"],
    "hasAlumnus": ["University"],
    "tenured": ["Professor"],
    "emailAddress": ["Person"],
}

RANGE = {  # 18 range axioms
    "advisor": ["Professor"],
    "degreeFrom": ["University"],
    "doctoralDegreeFrom": ["University"],
    "mastersDegreeFrom": ["University"],
    "undergraduateDegreeFrom": ["University"],
    "headOf": ["Department"],
    "worksFor": ["Organization"],
    "memberOf": ["Organization"],
    "member": ["Person"],
    "orgPublication": ["Publication"],
    "publicationAuthor": ["Person"],
    "publicationResearch": ["Research"],
    "researchProject": ["Research"],
    "softwareDocumentation": ["Publication"],
    "subOrganizationOf": ["Organization"],
    "takesCourse": ["Course"],
    "teacherOf": ["Course"],
    "teachingAssistantOf": ["Course"],
}


def lubm_ontology() -> Ontology:
    return Ontology(
        concepts=list(CONCEPTS),
        properties=list(PROPERTIES),
        subclass=list(SUBCLASS),
        subprop=list(SUBPROP),
        domain={k: list(v) for k, v in DOMAIN.items()},
        range_={k: list(v) for k, v in RANGE.items()},
    )
